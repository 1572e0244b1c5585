"""Inputs with exact ties for checking the K2 (``argmax_matmul``) kernels,
shared by ``chip_smoke.py`` and the tests.

The ties sit where the CUDA kernels' reduction could go wrong: (1, 2) two
lanes of one column group; (6, 11) the lower index in a later lane than its
copy; (63, 64) the f32 kernel's ref tiles; (127, 128) and (255, 256, 383)
the bf16 kernel's; (398, 399) and (998, 999) the ragged last tiles of
L_ref = 400 and 1000."""

import numpy as np

TIE_GROUPS = ((1, 2), (6, 11), (63, 64), (127, 128), (255, 256, 383),
              (398, 399), (998, 999))


def tied_rows(rng, n, l_ref, l_lr, d):
    """L2-normalised f32 rows ref (n, l_ref, d) and lr (n, l_lr, d). For each
    tie group inside L_ref, its ref rows are copies of its first and LR row
    i equals that first row, so row i's max is a tie only the lowest index
    may win. Returns ref, lr and those first indices (int32)."""
    ref = rng.standard_normal((n, l_ref, d)).astype(np.float32)
    lr = rng.standard_normal((n, l_lr, d)).astype(np.float32)
    groups = [g for g in TIE_GROUPS if g[-1] < l_ref]
    for i, group in enumerate(groups):
        ref[:, list(group[1:])] = ref[:, [group[0]]]
        lr[:, i] = ref[:, group[0]]
    ref /= np.linalg.norm(ref, axis=2, keepdims=True)
    lr /= np.linalg.norm(lr, axis=2, keepdims=True)
    return ref, lr, np.array([g[0] for g in groups], np.int32)
