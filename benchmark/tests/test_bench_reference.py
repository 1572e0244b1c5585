"""The plain reference against the program on the CPU, where the program
runs its kernels' plain versions in f32: the same frames and carried state
to rounding, through first windows, streamed windows and re-anchors, at
both configurations' widths."""

import pytest

from benchmark import core


@pytest.mark.parametrize("cell, config", [
    ("stream_8k_bf16", {"dtype": "float32"}),
    ("stream_1080p_f32", {"reset_branch": 3}),
    ("stream_1080p_f32", {}),
])
def test_reference_agrees_with_the_program(tiny, cell, config):
    # to rounding: limits a thousand times below the f32 cell's
    tight = {"sr_rmse": 1e-6, "sr_max_abs": 1e-5, "state_rel": 1e-5}
    reg = tiny(cell, config={"num_blocks": 4, "limits": tight, **config},
               traffic={"warmup_windows": config.get("reset_branch", 9)
                        if cell == "stream_1080p_f32" else 2})
    result, run = core.run_cell(reg, cell, 3, 2.0, False, device="cpu")
    kinds = {f["kind"] for f in run.frames}
    if config.get("reset_branch"):
        assert kinds == {"reanchor", "stream"}
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(tight)
