"""JAX (flax) parameters -> the port's state_dict.

The inverse of vaeplay_tpu/models/torch_convert.py's BP mapping
(`bp_from_torch`), for a param tree given as nested mappings of numpy arrays
(for example `jax.device_get(variables["params"])`). It imports neither JAX
nor the JAX package.

Layout conversions:
  conv    HWIO -> OIHW
  linear  (in, out) -> (out, in)
  ellipse_predictor.fcs.0: the JAX model flattens its 4x4 pooled map NHWC
          (h, w, c), the port NCHW (c, h, w); the input axis is permuted back
  gamma   as it is
The reference's dead `ellipse_predictor.convs.*` tensors are not produced.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(w):  # HWIO -> OIHW
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _lin(w):  # (in, out) -> (out, in)
    return np.transpose(np.asarray(w), (1, 0))


def _lin_to_nchw_flat(w, c: int, h: int, ww: int):
    """(h*w*c, out) kernel over an NHWC flatten -> torch (out, c*h*w) over an
    NCHW flatten; inverse of torch_convert._lin_from_nchw_flat."""
    out = np.asarray(w).shape[1]
    w = _lin(w).reshape(out, h, ww, c)
    return np.transpose(w, (0, 3, 1, 2)).reshape(out, c * h * ww)


def _convblock(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.conv.0.weight"] = _t(_conv(p["conv"]["kernel"]))
    sd[f"{prefix}.conv.0.bias"] = _t(p["conv"]["bias"])


def _linblock(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.fc.0.weight"] = _t(_lin(p["fc"]["kernel"]))
    sd[f"{prefix}.fc.0.bias"] = _t(p["fc"]["bias"])


def _attnblock(sd: Dict, prefix: str, p: Mapping) -> None:
    for name in ("q", "k", "v"):
        _convblock(sd, f"{prefix}.{name}", p[name])
    sd[f"{prefix}.gamma"] = _t(p["gamma"])


def bp_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/bp.ComposeNet params -> state_dict of the port's ComposeNet."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    n_enc = len([k for k in enc if k.startswith("conv")])
    for i in range(n_enc):
        _convblock(sd, f"encoder.convs.{i}", enc[f"conv{i}"])
    ell = params["ellipse_predictor"]
    for i in range(3):
        _linblock(sd, f"ellipse_predictor.fcs.{i}", ell[f"fc{i}"])
    fc0 = np.asarray(ell["fc0"]["fc"]["kernel"])
    c = fc0.shape[0] // 16
    sd["ellipse_predictor.fcs.0.fc.0.weight"] = _t(_lin_to_nchw_flat(fc0, c, 4, 4))

    elp = params["emit_line_predictor"]
    n_emit = len([k for k in elp if k.startswith("conv")])
    for i in range(n_emit):
        _convblock(sd, f"emit_line_predictor.convs.{i}", elp[f"conv{i}"])
    pp, prefix = elp["param_predictor"], "emit_line_predictor.param_predictor"
    ve = pp["value_encoder"]
    for i in range(4):
        _linblock(sd, f"{prefix}.value_encoder.fcs.{i}", ve[f"fc{i}"])
    for i in range(3):
        _attnblock(sd, f"{prefix}.value_encoder.attns.{i}", ve[f"attn{i}"])
        _attnblock(sd, f"{prefix}.batch_attention_a.{i}", pp[f"attn_a{i}"])
        _attnblock(sd, f"{prefix}.batch_attention_b.{i}", pp[f"attn_b{i}"])
        _linblock(sd, f"{prefix}.trigger_pred.{i}", pp[f"trig{i}"])
        _linblock(sd, f"{prefix}.params_pred.{i}", pp[f"param{i}"])
    return sd
