"""Weight bridge between the JAX package's parameter tree and the port.

The port's modules carry the reference torch state-dict keys, so a reference
``.pytorch`` checkpoint loads with ``load_reference_state_dict``. The JAX
package's parameters (a flax tree) come across with ``params_from_jax``,
which maps every flax leaf path to its reference key with this module's own
copy of the rules of ``refvsr_tpu/utils/convert.py:_torch_key_for`` (the
RefVSR subset) and transposes conv kernels HWIO -> OIHW. The JAX
``LossModule``'s parameters (``cx_<type>/vgg/conv_<i>``) come across into
the port's ``losses.LossModule`` with ``loss_params_from_jax``."""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_IGNORED_REFERENCE_KEYS = ("sub_mean", "mean", "std", "num_batches_tracked")


def _torch_key_for(path: tuple, leaf_shape) -> str:
    """flax param path (without 'params') -> reference state-dict key."""
    names = list(path)
    leaf = names.pop()
    suffix = "weight" if leaf == "kernel" else "bias"
    under_flownet = bool(names) and names[0] == "FlowNet"
    fixed = {"feat_fusion2_1": "feat_fusion2_1.0", "input_conv": "main.0",
             "conv1_0": "conv1.0", "conv1_res": "conv1.2",
             "p_conv_0": "p_conv.0", "p_conv_res": "p_conv.2",
             "p_conv_out": "p_conv.4"}
    out = []
    for n in names:
        m_bm = re.fullmatch(r"basic_module_(\d+)", n)
        m_conv = re.fullmatch(r"conv_(\d+)", n)
        m_rb = re.fullmatch(r"RBs_(\d+)", n)
        m_blk = re.fullmatch(r"block_(\d+)", n)
        m_seq = re.fullmatch(r"(.+)_seq([01])", n)
        m_enc = re.fullmatch(r"ref_encoder([12])_([01])", n)
        if m_bm:        # SPyNet module list
            out.append(f"basic_module.{m_bm.group(1)}")
        elif n == "match0":
            # the 1x1 match conv lives INSIDE feature_extract as map{64|128};
            # a bias cannot tell which, params_from_jax fixes it afterwards
            in_ch = leaf_shape[2] if suffix == "weight" and \
                len(leaf_shape) == 4 else None
            out.append(f"feature_extract.map{in_ch if in_ch == 128 else 64}")
        elif m_conv:
            idx = m_conv.group(1)
            if under_flownet:       # mmcv ConvModule in the SPyNet block
                out.append(f"basic_module.{idx}.conv")
            elif out and out[-1] == "feature_extract":
                out.append(idx)     # torchvision features.<i>
            else:
                out.append(f"conv_{idx}")
        elif m_enc:
            out.append(f"ref_encoder{m_enc.group(1)}.{m_enc.group(2)}")
        elif m_seq:
            out.append(f"{m_seq.group(1)}.{m_seq.group(2)}")
        elif m_rb:
            out.append(f"RBs.{m_rb.group(1)}")
        elif m_blk:
            out.append(f"main.2.{m_blk.group(1)}")
        elif n in fixed:
            out.append(fixed[n])
        elif n != "conv":           # the Conv2d wrapper's inner conv
            out.append(n)
    return ".".join(out) + "." + suffix


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's param tree, given as
    nested dicts of numpy arrays (with or without the top 'params')."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, leaf in _leaves(tree):
        v = np.asarray(leaf)
        key = _torch_key_for(path, v.shape)
        if key in sd:
            raise ValueError(f"torch key collision: {key} at {path}")
        if v.ndim == 4:             # HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.array(v, order="C"))
    # match0 bias fix-up: its tag follows its weight's
    for k in [k for k in sd if ".map64." in k and k.endswith(".bias")]:
        alt = k.replace(".map64.", ".map128.")
        if alt[:-len("bias")] + "weight" in sd:
            sd[alt] = sd.pop(k)
    return sd


def loss_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The port's LossModule state_dict from the JAX LossModule's param tree
    (nested dicts of numpy arrays, with or without the top 'params'):
    ``cx_<type>/vgg/conv_<i>/conv/{kernel,bias}`` ->
    ``cx_<type>.vgg.<i>.{weight,bias}``, kernels HWIO -> OIHW."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, leaf in _leaves(tree):
        cx, vgg, conv, inner, name = path
        m = re.fullmatch(r"conv_(\d+)", conv)
        if vgg != "vgg" or inner != "conv" or m is None:
            raise ValueError(f"not a loss VGG leaf: {path}")
        v = np.asarray(leaf)
        if v.ndim == 4:             # HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        suffix = "weight" if name == "kernel" else "bias"
        sd[f"{cx}.vgg.{m.group(1)}.{suffix}"] = torch.from_numpy(
            np.array(v, order="C"))
    return sd


def load_reference_state_dict(net: torch.nn.Module, sd, strict: bool = True):
    """Load a reference-keyed state dict (torch tensors or numpy arrays)
    into `net`: DDP 'module.' prefixes are stripped and the reference's
    MeanShift/statistics buffers, which the port does not hold, are
    dropped. Returns load_state_dict's result."""
    clean = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if any(s in k for s in _IGNORED_REFERENCE_KEYS):
            continue
        clean[k] = torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v
    return net.load_state_dict(clean, strict=strict)
