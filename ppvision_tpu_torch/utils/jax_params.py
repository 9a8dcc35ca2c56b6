"""Carry the JAX package's parameters over to the port's state_dicts.

The JAX package's parameter trees (nested dicts of arrays, given here
as numpy) become state_dicts with the reference PyTorch key names the
port's modules use.  This is the inverse of
``ppvision_tpu/utils/torch_import.py``: conv ``kernel`` (kh, kw, I, O)
-> ``weight`` (O, I, kh, kw); Dense ``kernel`` (I, O) -> ``weight``
(O, I); FrozenBatchNorm ``scale/bias/mean/var`` -> ``weight/bias/
running_mean/running_var``; InstanceNorm ``scale/bias`` ->
``weight/bias``.  It needs no JAX import: only dicts of arrays.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "camera_state_dict",
    "fan_state_dict",
    "generator_state_dict",
    "load_deid_params",
    "mapping_state_dict",
    "raft_state_dict",
    "style_encoder_state_dict",
]

Tree = Mapping[str, Any]

# Hourglass blocks in the JAX package's creation order -> reference names.
_HG_ORDER = [
    "b1_4", "b2_4", "b1_3", "b2_3", "b1_2", "b2_2",
    "b1_1", "b2_1", "b2_plus_1", "b3_1", "b3_2", "b3_3", "b3_4",
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out: dict, name: str, p: Tree) -> None:
    out[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _linear(out: dict, name: str, p: Tree) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _bn(out: dict, name: str, p: Tree) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    out[f"{name}.running_mean"] = _t(p["mean"])
    out[f"{name}.running_var"] = _t(p["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _inorm(out: dict, name: str, p: Tree) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def camera_state_dict(params) -> dict[str, torch.Tensor]:
    """``CameraParams`` (or a dict with the same fields) -> the
    reference's ``Zer_train`` / ``Zer_no_train`` of shape (n, 1, 1)."""
    get = params.get if isinstance(params, Mapping) else lambda k: getattr(params, k)
    return {
        "Zer_train": _t(get("zernike_train")).reshape(-1, 1, 1),
        "Zer_no_train": _t(get("zernike_frozen")).reshape(-1, 1, 1),
    }


def _dense_block(out: dict, name: str, p: Tree) -> None:
    for i in range(3):
        _bn(out, f"{name}.bn{i + 1}", p[f"FrozenBatchNorm_{i}"])
        _conv(out, f"{name}.conv{i + 1}", p[f"Conv_{i}"])
    if "Conv_3" in p:
        _bn(out, f"{name}.downsample.0", p["FrozenBatchNorm_3"])
        _conv(out, f"{name}.downsample.2", p["Conv_3"])


def fan_state_dict(tree: Tree) -> dict[str, torch.Tensor]:
    """``models.fan.FAN`` params -> the port's ``FAN`` state_dict."""
    out: dict[str, torch.Tensor] = {}
    _conv(out, "conv1.conv", tree["CoordConv_0"]["Conv_0"])
    _bn(out, "bn1", tree["FrozenBatchNorm_0"])
    for i, name in enumerate(("conv2", "conv3", "conv4")):
        _dense_block(out, name, tree[f"DenseConvBlock_{i}"])
    hg = tree["HourGlass_0"]
    _conv(out, "m0.coordconv.conv", hg["CoordConv_0"]["Conv_0"])
    for i, blk in enumerate(_HG_ORDER):
        _dense_block(out, f"m0.{blk}", hg[f"DenseConvBlock_{i}"])
    _dense_block(out, "top_m_0", tree["DenseConvBlock_3"])
    _conv(out, "conv_last0", tree["Conv_0"])
    _bn(out, "bn_end0", tree["FrozenBatchNorm_1"])
    _conv(out, "l0", tree["Conv_1"])
    return out


def _resblk(out: dict, name: str, p: Tree) -> None:
    # With a learned shortcut the 1x1 conv is the JAX block's Conv_0.
    if "Conv_2" in p:
        _conv(out, f"{name}.conv1x1", p["Conv_0"])
        _conv(out, f"{name}.conv1", p["Conv_1"])
        _conv(out, f"{name}.conv2", p["Conv_2"])
    else:
        _conv(out, f"{name}.conv1", p["Conv_0"])
        _conv(out, f"{name}.conv2", p["Conv_1"])
    if "InstanceNorm_0" in p:
        _inorm(out, f"{name}.norm1", p["InstanceNorm_0"])
        _inorm(out, f"{name}.norm2", p["InstanceNorm_1"])


def _count(tree: Tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def generator_state_dict(tree: Tree) -> dict[str, torch.Tensor]:
    """``models.stargan.Generator`` params -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    _conv(out, "from_rgb", tree["Conv_0"])
    for i in range(_count(tree, "ResBlk_")):
        _resblk(out, f"encode.{i}", tree[f"ResBlk_{i}"])
    for j in range(_count(tree, "AdainResBlk_")):
        p = tree[f"AdainResBlk_{j}"]
        _linear(out, f"decode.{j}.norm1.fc", p["AdaIN_0"]["Dense_0"])
        _conv(out, f"decode.{j}.conv1", p["Conv_0"])
        _linear(out, f"decode.{j}.norm2.fc", p["AdaIN_1"]["Dense_0"])
        _conv(out, f"decode.{j}.conv2", p["Conv_1"])
        if "Conv_2" in p:
            _conv(out, f"decode.{j}.conv1x1", p["Conv_2"])
    _inorm(out, "to_rgb.0", tree["InstanceNorm_0"])
    _conv(out, "to_rgb.2", tree["Conv_1"])
    return out


def mapping_state_dict(tree: Tree) -> dict[str, torch.Tensor]:
    """``models.stargan.MappingNetwork`` params -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    for i in range(4):
        _linear(out, f"shared.{2 * i}", tree[f"Dense_{i}"])
    num_domains = (_count(tree, "Dense_") - 4) // 4
    for d in range(num_domains):
        for i in range(4):
            _linear(out, f"unshared.{d}.{2 * i}", tree[f"Dense_{4 + 4 * d + i}"])
    return out


def style_encoder_state_dict(tree: Tree) -> dict[str, torch.Tensor]:
    """``models.stargan.StyleEncoder`` params -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    trunk = tree["_ConvTrunk_0"]
    repeat = _count(trunk, "ResBlk_")
    _conv(out, "shared.0", trunk["Conv_0"])
    for i in range(repeat):
        _resblk(out, f"shared.{1 + i}", trunk[f"ResBlk_{i}"])
    _conv(out, f"shared.{repeat + 2}", trunk["Conv_1"])
    for d in range(_count(tree, "Dense_")):
        _linear(out, f"unshared.{d}", tree[f"Dense_{d}"])
    return out


_RAFT_UPDATE = {
    "BasicMotionEncoder_0": ("encoder.convc1", "encoder.convc2", "encoder.convf1", "encoder.convf2", "encoder.conv"),
    "SepConvGRU_0": ("gru.convz1", "gru.convr1", "gru.convq1", "gru.convz2", "gru.convr2", "gru.convq2"),
    None: ("flow_head.conv1", "flow_head.conv2", "mask.0", "mask.2"),
}


def _raft_encoder(out: dict, prefix: str, tree: Tree) -> None:
    """BasicEncoder: fnet's instance norms carry no parameters; cnet's
    frozen BNs (``_Norm_*``) do.  The downsample norm is the reference's
    ``norm3`` and ``downsample.1`` at once."""
    _conv(out, f"{prefix}.conv1", tree["Conv_0"])
    if "_Norm_0" in tree:
        _bn(out, f"{prefix}.norm1", tree["_Norm_0"])
    for i in range(6):
        blk = tree[f"ResidualBlock_{i}"]
        name = f"{prefix}.layer{i // 2 + 1}.{i % 2}"
        _conv(out, f"{name}.conv1", blk["Conv_0"])
        _conv(out, f"{name}.conv2", blk["Conv_1"])
        for j in (0, 1):
            if f"_Norm_{j}" in blk:
                _bn(out, f"{name}.norm{j + 1}", blk[f"_Norm_{j}"])
        if "Conv_2" in blk:
            _conv(out, f"{name}.downsample.0", blk["Conv_2"])
            if "_Norm_2" in blk:
                _bn(out, f"{name}.downsample.1", blk["_Norm_2"])
                _bn(out, f"{name}.norm3", blk["_Norm_2"])
    _conv(out, f"{prefix}.conv2", tree["Conv_1"])


def raft_state_dict(tree: Tree) -> dict[str, torch.Tensor]:
    """``models.raft.RAFT`` params -> the port's ``RAFT`` state_dict (the
    reference raft-things key names); the inverse of
    ``torch_import.raft_params_from_torch``."""
    out: dict[str, torch.Tensor] = {}
    _raft_encoder(out, "fnet", tree["fnet"])
    _raft_encoder(out, "cnet", tree["cnet"])
    upd = tree["update_block"]
    for sub, names in _RAFT_UPDATE.items():
        p = upd if sub is None else upd[sub]
        for i, name in enumerate(names):
            _conv(out, f"update_block.{name}", p[f"Conv_{i}"])
    return out


def load_deid_params(bundle, params) -> None:
    """Load the JAX package's ``DeIdParams`` (any object with
    ``camera``, ``fan_priv``, ``generator``, ``mapping_network`` and
    ``style_encoder`` trees of arrays) into a port ``DeIdBundle``,
    strictly: every port key must be filled."""
    pairs = (
        (bundle.camera, camera_state_dict(params.camera)),
        (bundle.fan, fan_state_dict(params.fan_priv)),
        (bundle.generator, generator_state_dict(params.generator)),
        (bundle.mapping_network, mapping_state_dict(params.mapping_network)),
        (bundle.style_encoder, style_encoder_state_dict(params.style_encoder)),
    )
    for module, sd in pairs:
        module.load_state_dict(sd, strict=True)
