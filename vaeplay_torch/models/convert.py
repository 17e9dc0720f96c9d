"""JAX (flax) parameters -> the port's state_dict.

The inverse of vaeplay_tpu/models/torch_convert.py's BP and VAE-GAN mappings
(`bp_from_torch`, `vaegan_from_torch`), for trees given as nested mappings
of numpy arrays (for example `jax.device_get(variables["params"])`). It
imports neither JAX nor the JAX package.

Layout conversions:
  conv            HWIO -> OIHW
  conv-transpose  HWIO -> (I, O, kh, kw)
  linear          (in, out) -> (out, in)
  a linear over a flattened conv map (BP's ellipse_predictor.fcs.0, the
          VAE-GAN's encoder.fc.0 and discriminator.fc.0): the JAX model
          flattens NHWC (h, w, c), the port NCHW (c, h, w); the input axis
          is permuted back
  BatchNorm       scale, bias, mean, var -> weight, bias, running_mean,
                  running_var
  gamma           as it is
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


def _convT(w):  # HWIO -> torch ConvTranspose2d (I, O, kh, kw); not flipped: the
    # JAX block flips its kernel itself (vaeplay_tpu/core/layers.py:133)
    return np.transpose(np.asarray(w), (2, 3, 0, 1))


def _bn(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """flax BatchNorm scale, bias and (mean, var) -> weight, bias and the
    running buffers; num_batches_tracked 0 (unused at a fixed momentum)."""
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _linear(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(_lin(p["kernel"]))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def vaegan_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                               img_size: int) -> Dict[str, torch.Tensor]:
    """JAX models/vae_gan.VaeGan params and batch_stats -> state_dict of the
    port's VaeGan; the inverse of torch_convert.vaegan_from_torch."""
    import math

    levels = int(math.log2(img_size // 8))
    sd: Dict[str, torch.Tensor] = {}

    enc, enc_s = params["encoder"], batch_stats["encoder"]
    for i in range(levels):
        sd[f"encoder.conv.{i}.conv.weight"] = _t(_conv(enc[f"block{i}"]["conv"]["kernel"]))
        _bn(sd, f"encoder.conv.{i}.bn", enc[f"block{i}"]["bn"], enc_s[f"block{i}"]["bn"])
    size = 64 * 2 ** (levels - 1)
    sd["encoder.fc.0.weight"] = _t(_lin_to_nchw_flat(enc["fc"]["kernel"], size, 8, 8))
    _bn(sd, "encoder.fc.1", enc["fc_bn"], enc_s["fc_bn"])
    _linear(sd, "encoder.l_mu", enc["l_mu"])
    _linear(sd, "encoder.l_var", enc["l_var"])

    dec, dec_s = params["decoder"], batch_stats["decoder"]
    _linear(sd, "decoder.fc.0", dec["fc"])  # its output is channel-major on both sides
    _bn(sd, "decoder.fc.1", dec["fc_bn"], dec_s["fc_bn"])
    for i in range(levels):
        sd[f"decoder.conv.{i}.conv.weight"] = _t(_convT(dec[f"block{i}"]["conv"]["kernel"]))
        _bn(sd, f"decoder.conv.{i}.bn", dec[f"block{i}"]["bn"], dec_s[f"block{i}"]["bn"])
    sd[f"decoder.conv.{levels}.0.weight"] = _t(_conv(dec["out_conv"]["kernel"]))
    sd[f"decoder.conv.{levels}.0.bias"] = _t(dec["out_conv"]["bias"])

    dis, dis_s = params["discriminator"], batch_stats["discriminator"]
    sd["discriminator.conv.0.0.weight"] = _t(_conv(dis["stem"]["kernel"]))
    sd["discriminator.conv.0.0.bias"] = _t(dis["stem"]["bias"])
    for i in range(1, levels + 1):
        sd[f"discriminator.conv.{i}.conv.weight"] = _t(_conv(dis[f"block{i}"]["conv"]["kernel"]))
        _bn(sd, f"discriminator.conv.{i}.bn", dis[f"block{i}"]["bn"], dis_s[f"block{i}"]["bn"])
    sd["discriminator.fc.0.weight"] = _t(_lin_to_nchw_flat(dis["fc0"]["kernel"],
                                                           32 * 2 ** levels, 8, 8))
    _bn(sd, "discriminator.fc.1", dis["fc_bn"], dis_s["fc_bn"])
    _linear(sd, "discriminator.fc.3", dis["fc1"])

    pe = params["param_encoder"]
    for jax_name, torch_name in (("head0", "head.0"), ("head1", "head.1"), ("head2", "head.2"),
                                 ("head3", "head.3"), ("r0", "r_fc.0"), ("r1", "r_fc.1"),
                                 ("xy0", "xy_fc.0"), ("xy1", "xy_fc.1")):
        _linear(sd, f"param_encoder.{torch_name}", pe[jax_name])
    return sd
