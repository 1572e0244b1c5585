"""Weight bridge between the JAX package's parameter tree and the port.

The port's modules carry the reference torch state-dict keys, so a reference
``.pytorch`` checkpoint loads with ``load_reference_state_dict``. The JAX
package's parameters (a flax tree) come across with ``params_from_jax``,
which maps every flax leaf path to its reference key with this module's own
copy of the rules of ``refvsr_tpu/utils/convert.py:_torch_key_for`` (those
of RefVSR and of RefVSR-IR's EDVR) and transposes conv kernels HWIO ->
OIHW. The JAX ``LossModule``'s parameters (``cx_<type>/vgg/conv_<i>``) come across into
the port's ``losses.LossModule`` with ``loss_params_from_jax``.

The pretrained third-party assets that the reference loads at model
construction (the frozen SPyNet, ``./ckpt/SPyNet.pytorch``, and torchvision
VGG19 for the matching prefix and the contextual losses) come in with
``load_pretrained_assets``, the counterpart of the JAX package's loader of
the same name; it fills the port's modules in place."""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, Mapping

import numpy as np
import torch

_IGNORED_REFERENCE_KEYS = ("sub_mean", "mean", "std", "num_batches_tracked")


def _torch_key_for(path: tuple, leaf_shape) -> str:
    """flax param path (without 'params') -> reference state-dict key."""
    names = list(path)
    leaf = names.pop()
    # ModulatedDCNPack declares its own torch-named weight and bias
    suffix = "weight" if leaf in ("kernel", "weight") else "bias"
    under_flownet = bool(names) and names[0] == "FlowNet"
    fixed = {"feat_fusion2_1": "feat_fusion2_1.0", "input_conv": "main.0",
             "conv1_0": "conv1.0", "conv1_res": "conv1.2",
             "p_conv_0": "p_conv.0", "p_conv_res": "p_conv.2",
             "p_conv_out": "p_conv.4"}
    out = []
    for i, n in enumerate(names):
        nxt = names[i + 1] if i + 1 < len(names) else None
        m_fe = re.fullmatch(r"feature_extraction_(\d+)", n)
        m_lvl = re.fullmatch(r"(offset_conv\d|dcn_pack|feat_conv)_l(\d)", n)
        m_bm = re.fullmatch(r"basic_module_(\d+)", n)
        m_conv = re.fullmatch(r"conv_(\d+)", n)
        m_rb = re.fullmatch(r"RBs_(\d+)", n)
        m_blk = re.fullmatch(r"block_(\d+)", n)
        m_seq = re.fullmatch(r"(.+)_seq([01])", n)
        m_enc = re.fullmatch(r"ref_encoder([12])_([01])", n)
        if m_fe:        # EDVR's make_layer Sequential
            out.append(f"feature_extraction.{m_fe.group(1)}")
        elif m_lvl:     # PCDAlignment's ModuleDicts keyed l<i>
            out.append(f"{m_lvl.group(1)}.l{m_lvl.group(2)}")
        elif m_bm:      # SPyNet module list
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
        elif n != "conv":
            out.append(n)
        elif nxt == "conv":
            # the Conv2d wrapper's inner conv is dropped; a doubled one is
            # an mmcv ConvModule's own ``conv``
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


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pytorch``/``.pth`` file's state dict on the CPU (a top-level
    ``state_dict`` entry is unwrapped); values that are not tensors become
    tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in obj.items()}


def load_spynet_weights(sd, net: torch.nn.Module) -> int:
    """Fill ``net.FlowNet`` from a standalone SPyNet state dict (mmedit
    layout, ``basic_module.{i}.basic_module.{j}.conv.{weight,bias}``; a
    ``module.`` prefix is stripped). Raises on a missing key or a shape
    mismatch, before anything is written. Returns the number of tensors
    filled."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    found, missing = [], []
    for key, p in net.FlowNet.named_parameters():
        if key not in sd:
            missing.append(key)
            continue
        w = torch.as_tensor(sd[key])
        if w.shape != p.shape:
            raise ValueError(f"SPyNet shape mismatch for {key}: checkpoint "
                             f"{tuple(w.shape)} vs {tuple(p.shape)}")
        found.append((p, w))
    if missing:
        raise ValueError(f"SPyNet conversion incomplete: missing={missing}")
    with torch.no_grad():
        for p, w in found:
            p.copy_(w)
    return len(found)


_VGG_KEY = re.compile(r"(?:^|\.)(?:feature_extract|vgg)\.(\d+)\."
                      r"(weight|bias)$")


def load_vgg19_features(vgg_sd, module: torch.nn.Module) -> int:
    """Fill every VGG19 prefix in `module` (the matching's
    ``feature_extract`` and the contextual losses' ``vgg``, whose convs sit
    under their torchvision ``features`` index) from a torchvision vgg19
    state dict (``features.<idx>.{weight,bias}``; the classifier is
    ignored). A tensor whose key is absent or whose shape differs is left as
    it is. Returns the number of tensors filled."""
    count = 0
    with torch.no_grad():
        for key, p in module.named_parameters():
            m = _VGG_KEY.search(key)
            if m is None:
                continue
            w = vgg_sd.get(f"features.{m.group(1)}.{m.group(2)}")
            if w is not None and tuple(w.shape) == tuple(p.shape):
                p.copy_(torch.as_tensor(w))
                count += 1
    return count


def load_pretrained_assets(config, net: torch.nn.Module,
                           loss_mod: torch.nn.Module = None) -> dict:
    """Load the frozen SPyNet (``config.spynet_ckpt``) into ``net.FlowNet``
    and torchvision VGG19 (``config.vgg19_ckpt``) into the net's matching
    prefix and, when given, the loss module's VGGs, in place. A configured
    file that is absent (or a field that is None) warns loudly: the run
    then trains against random frozen flow and VGG features. Returns a
    report of the tensors filled: ``spynet_leaves``, ``vgg_net_leaves`` and,
    when the VGG file was read and `loss_mod` given, ``vgg_loss_leaves``."""
    report = {}
    sp = config.spynet_ckpt
    if sp and os.path.exists(sp):
        report["spynet_leaves"] = load_spynet_weights(
            load_torch_checkpoint(sp), net)
    else:
        warnings.warn(
            f"spynet_ckpt {sp!r} not found — the frozen flow network keeps "
            "its RANDOM init (the reference loads ./ckpt/SPyNet.pytorch). "
            "Place the file there or set config.spynet_ckpt.", stacklevel=2)
        report["spynet_leaves"] = 0

    vg = config.vgg19_ckpt
    if vg and os.path.exists(vg):
        vsd = load_torch_checkpoint(vg)
        report["vgg_net_leaves"] = load_vgg19_features(vsd, net)
        if loss_mod is not None:
            report["vgg_loss_leaves"] = load_vgg19_features(vsd, loss_mod)
    else:
        warnings.warn(
            f"vgg19_ckpt {vg!r} not found — the matching prefix and the "
            "contextual losses' VGGs keep their RANDOM init (the reference "
            "uses pretrained torchvision vgg19).", stacklevel=2)
        report["vgg_net_leaves"] = 0
    return report
