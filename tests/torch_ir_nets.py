"""Shared set-up of the RefVSR-IR parity tests: a tiny port net with
seeded weights (offset convs redrawn, so that the deformable convolutions
sample at fractional positions) and the same weights in the JAX net's
parameter tree, carried across by the JAX package's
``convert_state_dict``."""

import jax
import numpy as np
import torch

from refvsr_tpu.models.refvsr import init_stream_state as jax_init_state
from refvsr_tpu.models.refvsr_ir import RefVSRIRNet as JaxIRNet
from refvsr_tpu.utils.convert import convert_state_dict
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.edvr import ModulatedDCNPack
from refvsr_tpu_torch.models.refvsr_ir import RefVSRIRNet

T, BLOCKS, MID, STRIDE = 5, 2, 8, 2


def port_net(seed=3, offset_std=0.1, **kw):
    net = RefVSRIRNet(scale=4, num_blocks=BLOCKS, mid_channels=MID,
                      matching_ksize=2, keyframe_stride=STRIDE, **kw)
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ModulatedDCNPack):
                m.conv_offset.weight.copy_(torch.randn(
                    m.conv_offset.weight.shape, generator=gen) * offset_std)
    return net


def jax_params(net, h, w, jnet=None):
    """`net`'s weights as the JAX IR net's parameter tree (every leaf
    filled, every key used)."""
    jnet = jnet or JaxIRNet(scale=4, num_blocks=BLOCKS, mid_channels=MID,
                            matching_ksize=2, keyframe_stride=STRIDE)
    lrs = np.zeros((1, T, h, w, 3), np.float32)
    refs = np.zeros((1, T, 2 * h, 2 * w, 3), np.float32)
    mask = np.ones(T, bool)
    shapes = jax.eval_shape(
        lambda a, b: jnet.init(jax.random.PRNGKey(0), a, b,
                               jax_init_state(1, h, w, MID, num_frames=T),
                               mask), lrs, refs)
    params, missing, unused = convert_state_dict(
        {k: v.detach().numpy() for k, v in net.state_dict().items()},
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               shapes))
    assert not missing and not unused, (missing, unused)
    return params
