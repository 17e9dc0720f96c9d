"""JAX (flax) parameters -> the port's state_dict.

The inverse of vaeplay_tpu/models/torch_convert.py's BP, VAE-GAN and BE
mappings (`bp_from_torch`, `vaegan_from_torch`, `be_from_torch`, and for BE's
backbone vaeplay_tpu/models/backbone.py's `convert_torchvision_state_dict`),
for trees given as nested mappings of numpy arrays (for example
`jax.device_get(variables["params"])`). It imports neither JAX nor the JAX
package.

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
  FrozenBatchNorm the `constants` scale, bias, mean, var -> the same four
                  buffers
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


def _frozen_bn(sd: Dict, prefix: str, c: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(c["scale"])
    sd[f"{prefix}.bias"] = _t(c["bias"])
    sd[f"{prefix}.running_mean"] = _t(c["mean"])
    sd[f"{prefix}.running_var"] = _t(c["var"])


def _bn_convblock(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A ConvBlock with bn="batch": `conv.0` (no bias) and the BN `conv.1`."""
    sd[f"{prefix}.conv.0.weight"] = _t(_conv(p["conv"]["kernel"]))
    _bn(sd, f"{prefix}.conv.1", p["norm"], s["norm"])


def backbone_state_dict_from_jax(params: Mapping, constants: Mapping,
                                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX ResNetFPN's params and constants -> the port's ResNetFPN keys
    (torchvision's vocabulary), each under `prefix`; the block counts come
    from the tree, so slim variants convert too."""
    sd: Dict[str, torch.Tensor] = {}
    body, body_c = params["body"], constants["body"]
    sd[f"{prefix}body.conv1.weight"] = _t(_conv(body["conv1"]["kernel"]))
    _frozen_bn(sd, f"{prefix}body.bn1", body_c["bn1"])
    for li in range(1, 5):
        blocks = sum(1 for k in body if k.startswith(f"layer{li}_block"))
        for bi in range(blocks):
            src, dst = f"layer{li}_block{bi}", f"{prefix}body.layer{li}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{dst}.conv{ci}.weight"] = _t(_conv(body[src][f"conv{ci}"]["kernel"]))
                _frozen_bn(sd, f"{dst}.bn{ci}", body_c[src][f"bn{ci}"])
            if "down_conv" in body[src]:
                sd[f"{dst}.downsample.0.weight"] = _t(_conv(body[src]["down_conv"]["kernel"]))
                _frozen_bn(sd, f"{dst}.downsample.1", body_c[src]["down_bn"])
    fpn = params["fpn"]
    for i in range(4):
        for src, dst in ((f"inner{i}", f"inner_blocks.{i}"), (f"layer{i}", f"layer_blocks.{i}")):
            sd[f"{prefix}fpn.{dst}.weight"] = _t(_conv(fpn[src]["kernel"]))
            sd[f"{prefix}fpn.{dst}.bias"] = _t(fpn[src]["bias"])
    return sd


def be_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                           constants: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/be.ComposeNet variables -> state_dict of the port's
    ComposeNet; the inverse of torch_convert.be_from_torch. The heads'
    pred{1,2,3} hold canonical (3, 3, C, F) kernels (SmallChannelConv3x3S1),
    which become predictor.{0,1,2}.conv.0."""
    fn, fn_s = params["feature_net"], batch_stats["feature_net"]
    sd = backbone_state_dict_from_jax(fn["backbone"], constants["feature_net"]["backbone"],
                                      "feature_net.backbone.")
    n_aux = len([k for k in fn if k.startswith("aux")])
    for j in range(n_aux):
        name = f"aux{j // 2}{'ab'[j % 2]}"
        _bn_convblock(sd, f"feature_net.aux_convs.{j}", fn[name], fn_s[name])
    for head in ("mask_net", "edge_net"):
        p, s = params[head], batch_stats[head]
        for up, torch_up in (("up1", "conv1"), ("up2", "conv2")):
            for j, name in ((0, "conv1"), (1, "conv2")):
                _bn_convblock(sd, f"{head}.{torch_up}.conv.{j}", p[up][name], s[up][name])
        for i in range(3):
            sd[f"{head}.predictor.{i}.conv.0.weight"] = _t(_conv(p[f"pred{i + 1}"]["kernel"]))
            sd[f"{head}.predictor.{i}.conv.0.bias"] = _t(p[f"pred{i + 1}"]["bias"])
    return sd
