"""JAX (flax) parameters -> the port's state_dict.

The inverse of vaeplay_tpu/models/torch_convert.py's BP, VAE-GAN, BE,
BE_GAN, BC, BCP and BE_font mappings (`bp_from_torch`, `vaegan_from_torch`,
`be_from_torch`, `be_gan_from_torch`, `be_gan_disc_from_torch`,
`bc_from_torch`, `bcp_from_torch`, `bcp_disc_from_torch`,
`be_font_from_torch`, `be_font_disc_from_torch`, `style_encoder_from_torch`,
`style_generator_from_torch`, `style_discriminator_from_torch`, and for the backbone
vaeplay_tpu/models/backbone.py's `convert_torchvision_state_dict`),
for trees given as nested mappings of numpy arrays (for example
`jax.device_get(variables["params"])`). It imports neither JAX nor the JAX
package.

Layout conversions:
  conv            HWIO -> OIHW
  conv-transpose  HWIO -> (I, O, kh, kw)
  linear          (in, out) -> (out, in)
  a linear over a flattened conv map (BP's ellipse_predictor.fcs.0, the
          VAE-GAN's encoder.fc.0 and discriminator.fc.0, BE_font's
          relay_convs.0 and each Classifier's cls_convs.0): the JAX model
          flattens NHWC (h, w, c), the port NCHW (c, h, w); the input axis
          is permuted back
  a linear whose output is reshaped into a map (BE_font's relay_convs.1):
          its output axis and bias, the same way
  BatchNorm       scale, bias, mean, var -> weight, bias, running_mean,
                  running_var
  FrozenBatchNorm the `constants` scale, bias, mean, var -> the same four
                  buffers
  gamma           as it is
The reference's dead `ellipse_predictor.convs.*` tensors are not produced.
"""

import math
from typing import Dict, Mapping

import numpy as np
import torch

from vaeplay_torch.models.be_font import LABEL_EMBED, STYLE_EMBED


def _t(a) -> torch.Tensor:
    """An f32 tensor, or f64 for an f64 array (a test's gradient tree)."""
    a = np.asarray(a)
    return torch.tensor(a if a.dtype == np.float64 else a.astype(np.float32))


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
    """A ConvBlock's conv, and its bias where it has one (no norm)."""
    sd[f"{prefix}.conv.0.weight"] = _t(_conv(p["conv"]["kernel"]))
    if "bias" in p["conv"]:
        sd[f"{prefix}.conv.0.bias"] = _t(p["conv"]["bias"])


def _linblock(sd: Dict, prefix: str, p: Mapping) -> None:
    """A DenseBlock's linear layer, and its bias where it has one."""
    sd[f"{prefix}.fc.0.weight"] = _t(_lin(p["fc"]["kernel"]))
    if "bias" in p["fc"]:
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
    _aux_chain(sd, "feature_net.aux_convs", fn, fn_s)
    for head in ("mask_net", "edge_net"):
        _masknet(sd, head, params[head], batch_stats[head])
    return sd


def _aux_chain(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """The JAX aux{i}a/aux{i}b BN ConvBlocks -> `<prefix>.{2i, 2i+1}`."""
    n_aux = len([k for k in p if k.startswith("aux")])
    for j in range(n_aux):
        name = f"aux{j // 2}{'ab'[j % 2]}"
        _bn_convblock(sd, f"{prefix}.{j}", p[name], s[name])


def _masknet(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A JAX MaskNet/EdgeNet: up1/up2 -> conv1/conv2, and pred{1,2,3}, which
    hold canonical (3, 3, C, F) kernels (SmallChannelConv3x3S1) ->
    predictor.{0,1,2}.conv.0."""
    for up, torch_up in (("up1", "conv1"), ("up2", "conv2")):
        for j, name in ((0, "conv1"), (1, "conv2")):
            _bn_convblock(sd, f"{prefix}.{torch_up}.conv.{j}", p[up][name], s[up][name])
    for i in range(3):
        sd[f"{prefix}.predictor.{i}.conv.0.weight"] = _t(_conv(p[f"pred{i + 1}"]["kernel"]))
        sd[f"{prefix}.predictor.{i}.conv.0.bias"] = _t(p[f"pred{i + 1}"]["bias"])


def be_gan_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                               constants: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/be_gan.ComposeNet variables -> state_dict of the port's
    BE_GAN generator; the inverse of torch_convert.be_gan_from_torch."""
    sd = backbone_state_dict_from_jax(params["backbone"], constants["backbone"], "backbone.")
    _aux_chain(sd, "aux_convs", params, batch_stats)
    for head in ("mask_net", "edge_net"):
        _masknet(sd, head, params[head], batch_stats[head])
    return sd


def be_gan_disc_state_dict_from_jax(params: Mapping,
                                    batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/be_gan.Discriminator params and batch_stats -> state_dict of
    the port's Discriminator; the inverse of torch_convert.
    be_gan_disc_from_torch. Each MaskMapper's conv0 (SmallChannelConv3x3S2)
    holds the canonical (3, 3, 2, 16) kernel of `convs.0`."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("content_disc", "boundary_disc"):
        p, s = params[name], batch_stats[name]
        sd[f"{name}.convs.0.conv.0.weight"] = _t(_conv(p["conv0"]["kernel"]))
        sd[f"{name}.convs.0.conv.0.bias"] = _t(p["conv0"]["bias"])
        _convblock(sd, f"{name}.convs.1", p["conv1"])
        for i in range(sum(1 for k in p if k.startswith("feat") and k.endswith("a"))):
            for j, half in ((0, "a"), (1, "b")):
                _bn_convblock(sd, f"{name}.feat_modules.{i}.{j}", p[f"feat{i}{half}"],
                              s[f"feat{i}{half}"])
        _convblock(sd, f"{name}.pooler.0", p["pool_conv"])
    for i in range(3):
        _linear(sd, f"predictor.{i}.fc.0", params[f"pred{i}"]["fc"])
    return sd


def bc_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                           constants: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/bc.ComposeNet variables -> state_dict of the port's BC
    ComposeNet; the inverse of torch_convert.bc_from_torch. MaskNet's p1/p2
    (SmallChannelConv3x3S1) and EdgeNet's OneChannelConv3x3 hold canonical
    (3, 3, C, F) kernels; RefineNet's fc kernels flatten (point, feature)
    on both sides, so they only transpose. bf16 fc tensors (refine_fc_dtype)
    come out as f32 holding the same values, which a bf16 model loads
    exactly."""
    sd = backbone_state_dict_from_jax(params["feature_net"]["feature"],
                                      constants["feature_net"]["feature"], "feature_net.feature.")
    mn, mn_s = params["mask_net"], batch_stats["mask_net"]
    for name, key in (("c1a", "conv1.0"), ("c1b", "conv1.1"), ("c1c", "conv1.2"),
                      ("c2a", "conv2.0"), ("c2b", "conv2.1")):
        _bn_convblock(sd, f"mask_net.{key}", mn[name], mn_s[name])
    for i in range(2):
        _convblock(sd, f"mask_net.predictor.{i}", {"conv": mn[f"p{i + 1}"]})
    en = params["edge_net"]
    for i in range(3):
        _convblock(sd, f"edge_net.conv1.{i}", {"conv": en[f"c{i}"]})
    for i in range(2):
        _convblock(sd, f"edge_net.predictor.{i}", {"conv": en[f"p{i}"]})
    rn = params["refine_net"]
    for i in range(6):
        _attnblock(sd, f"refine_net.deform_blocks.{i}", rn[f"attn{i}"])
    for i in range(2):
        sd[f"refine_net.fc_blocks.{i}.weight"] = _t(_lin(rn[f"fc{i}"]["kernel"]))
        sd[f"refine_net.fc_blocks.{i}.bias"] = _t(rn[f"fc{i}"]["bias"])
    return sd


def _bcp_towers(enc: Mapping) -> Dict[str, Mapping]:
    """BCP's encoder params as the dual layout {a{i}, b{i}: {c0, c1, c2:
    {conv: {kernel[, bias]}}}}: the dual layout as it is, or the merged one
    (m{i}: {c}_kernel_a/_b, {c}_bias_a, c1_bias_b; merge_encoder_params,
    models/bcp.py) split back, moving kernels and biases unchanged."""
    if not any(k.startswith("m") for k in enc):
        return enc
    dual = {}
    for i in range(len(enc)):
        m = enc[f"m{i}"]
        for half in "ab":
            dual[f"{half}{i}"] = {c: {"conv": {"kernel": m[f"{c}_kernel_{half}"],
                                               **({"bias": m[f"{c}_bias_{half}"]}
                                                  if f"{c}_bias_{half}" in m else {})}}
                                  for c in ("c0", "c1", "c2")}
    return dual


def bcp_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/bcp.ComposeNet params, in the merged or the dual encoder
    layout, -> state_dict of the port's BCP ComposeNet; the inverse of
    torch_convert.bcp_from_torch. The point attention's blocks, which
    bcp_from_torch does not map (the reference left them commented out),
    battn{i} -> line_predictor.batch_attention.{i}."""
    sd: Dict[str, torch.Tensor] = {}
    for name, blk in _bcp_towers(params["encoder"]).items():
        tower = "convs1" if name[0] == "a" else "convs2"
        for j in range(3):
            _convblock(sd, f"encoder.{tower}.{name[1:]}.convs.{j}", blk[f"c{j}"])
    cls = params["cls_classifier"]
    for i in range(len([k for k in cls if k.startswith("conv")])):
        _convblock(sd, f"cls_classifier.convs.{i}", cls[f"conv{i}"])
    for i in range(3):
        _linblock(sd, f"cls_classifier.cls_convs.{i}", cls[f"fc{i}"])
    lp = params["line_predictor"]
    level = len([k for k in lp if k.startswith("freq") and k[4:].isdigit()])
    for i in range(level):
        _convblock(sd, f"line_predictor.frequency_encode_img.{i}", lp[f"freq{i}"])
    _convblock(sd, f"line_predictor.frequency_encode_img.{level}", lp["freq_out"])
    for prefix, name, n in (("frequency_encode_img_sub", "freq_fc", 3),
                            ("frequency_head", "fh", 2), ("params_pred", "pp", 3),
                            ("frequency_pred", "fp", 3)):
        for i in range(n):
            _linblock(sd, f"line_predictor.{prefix}.{i}", lp[f"{name}{i}"])
    for i in range(len([k for k in lp if k.startswith("battn")])):
        _attnblock(sd, f"line_predictor.batch_attention.{i}", lp[f"battn{i}"])
    return sd


def bcp_disc_state_dict_from_jax(params: Mapping, image_size: int) -> Dict[str, torch.Tensor]:
    """JAX models/bcp.Discriminator params -> state_dict of the port's BCP
    Discriminator; the inverse of torch_convert.bcp_disc_from_torch."""
    level = int(math.log2(image_size)) - 2 - 1
    sd: Dict[str, torch.Tensor] = {}
    for i in range(level):
        _convblock(sd, f"global_convs.{i}", params[f"g{i}"])
    _convblock(sd, f"global_convs.{level}", params["g_out"])
    for i in range(level):
        _linblock(sd, f"local_convs.{2 * i}", params[f"l{i}a"])
        _linblock(sd, f"local_convs.{2 * i + 1}", params[f"l{i}b"])
    _linblock(sd, f"local_convs.{2 * level}", params["l_out"])
    for i in range(5):
        _linblock(sd, f"merge_convs.{i}", params[f"m{i}"])
    return sd


def _embeding_block(sd: Dict, prefix: str, p: Mapping) -> None:
    """A JAX EmbedingBlock: fc0, fc1 -> convs_first.{0,1}, attn{i} ->
    attention.{i}, e0, e1 -> embeding.{0,1}."""
    for i in range(2):
        _linblock(sd, f"{prefix}.convs_first.{i}", p[f"fc{i}"])
        _linblock(sd, f"{prefix}.embeding.{i}", p[f"e{i}"])
    for i in range(3):
        _attnblock(sd, f"{prefix}.attention.{i}", p[f"attn{i}"])


def _embed_pair(sd: Dict, prefix: str, p: Mapping) -> None:
    _embeding_block(sd, f"{prefix}.label_encode_block", p["label"])
    _embeding_block(sd, f"{prefix}.style_encode_block", p["style"])


def _flat_map_linear(sd: Dict, prefix: str, p: Mapping, c: int) -> None:
    """A DenseBlock over [an NHWC-flattened c-channel square map, the two
    embeddings]: the map's input rows permuted to NCHW order, the rest as
    they are."""
    kernel = np.asarray(p["fc"]["kernel"])
    flat = kernel.shape[0] - LABEL_EMBED - STYLE_EMBED
    side = math.isqrt(flat // c)
    sd[f"{prefix}.fc.0.weight"] = _t(np.concatenate(
        [_lin_to_nchw_flat(kernel[:flat], c, side, side), _lin(kernel[flat:])], axis=1))
    sd[f"{prefix}.fc.0.bias"] = _t(p["fc"]["bias"])


def be_font_state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/be_font.ComposeNet params and batch_stats -> state_dict of
    the port's ComposeNet; the inverse of torch_convert.be_font_from_torch.
    The widths come from the arrays, so slim models (min_channel,
    max_channel) convert too. relay0's map rows and relay1's output columns
    and bias cross the NHWC/NCHW boundary; relay0's output and relay1's
    input are a latent with no layout and are not permuted."""
    sd: Dict[str, torch.Tensor] = {}
    _convblock(sd, "down.0", params["down0"])
    n = sum(1 for k in params if k.startswith("ups_"))
    for i in range(n):
        _bn_convblock(sd, f"down.{i + 1}.0", params[f"down_blocks_{i}_0"],
                      batch_stats[f"down_blocks_{i}_0"])
        _convblock(sd, f"down.{i + 1}.1", params[f"down_blocks_{i}_1"])
        for j, name in ((0, "conv1"), (1, "conv2")):
            _bn_convblock(sd, f"up.{i}.conv.{j}", params[f"ups_{i}"][name],
                          batch_stats[f"ups_{i}"][name])
        _convblock(sd, f"skip.{i}", params[f"skips_{i}"])
        _convblock(sd, f"cat.{i}", params[f"cats_{i}"])
    _embed_pair(sd, "embeding_block", params["embeding_block"])
    for half in ("label", "style"):
        blk = params["style_encoder"][half]
        convs = [blk["c0"]] + [blk[f"c{i}"] for i in range(1, len(blk) - 1)] + [blk["c_out"]]
        for i, p in enumerate(convs):
            _convblock(sd, f"style_encoder.{half}_encode_block.convs.{i}", p)
    c = np.asarray(params[f"down_blocks_{n - 1}_1"]["conv"]["kernel"]).shape[3]
    _flat_map_linear(sd, "relay_convs.0", params["relay0"], c)
    w1 = _lin(params["relay1"]["fc"]["kernel"])  # (out in (h, w, c) order, in)
    relay_in = w1.shape[0]
    sd["relay_convs.1.fc.0.weight"] = _t(
        w1.reshape(4, 4, c, relay_in).transpose(2, 0, 1, 3).reshape(relay_in, relay_in))
    sd["relay_convs.1.fc.0.bias"] = _t(
        np.asarray(params["relay1"]["fc"]["bias"]).reshape(4, 4, c).transpose(2, 0, 1).reshape(-1))
    for head in ("mask_net", "edge_net"):
        for i in range(3):
            _convblock(sd, f"{head}.predictor.{i}", params[head][f"p{i}"])
    return sd


def be_font_disc_state_dict_from_jax(params: Mapping,
                                     batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/be_font.Discriminator params and batch_stats -> state_dict
    of the port's Discriminator; the inverse of
    torch_convert.be_font_disc_from_torch. Each Classifier's fc0 reads the
    flattened 1024-channel map first: those rows are permuted to NCHW."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("adv_convs", "aux_convs"):
        p, s = params[name], batch_stats[name]
        _convblock(sd, f"{name}.conv_first", p["c0"])
        for i in range(4):
            if "norm" in p[f"c{i + 1}"]:
                _bn_convblock(sd, f"{name}.backbone.{i}", p[f"c{i + 1}"], s[f"c{i + 1}"])
            else:
                _convblock(sd, f"{name}.backbone.{i}", p[f"c{i + 1}"])
        _embed_pair(sd, f"{name}.embeding_block", p["embed"])
        _flat_map_linear(sd, f"{name}.cls_convs.0", p["fc0"], 1024)
        for i in (1, 2):
            _linblock(sd, f"{name}.cls_convs.{i}", p[f"fc{i}"])
    return sd


def _conv_with_bias(sd: Dict, prefix: str, p: Mapping) -> None:
    """A plain conv's {kernel, bias} -> `{prefix}.weight`, `{prefix}.bias`."""
    sd[f"{prefix}.weight"] = _t(_conv(p["kernel"]))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(_convT(p["kernel"]))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _levels(params: Mapping) -> int:
    """The number of stride-2 levels c1..cn of a Style_GAN encoder or
    discriminator tree."""
    return sum(1 for k in params if k[1:].isdigit() and k != "c0")


def style_encoder_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/style_gan.StyleEncoder params -> state_dict of the port's
    StyleEncoder; the inverse of torch_convert.style_encoder_from_torch. The
    levels and widths come from the arrays; fc_mu and fc_logvar read a 1 x 1
    map, whose NHWC and NCHW flattens agree (the port's model asserts the
    1 x 1)."""
    sd: Dict[str, torch.Tensor] = {}
    n = _levels(params)
    for i in range(n + 1):
        _convblock(sd, f"convs.{i}", params[f"c{i}"])
    _convblock(sd, f"convs.{n + 1}", params["c_extra0"])
    _convblock(sd, f"convs.{n + 2}", params["c_extra1"])
    _linblock(sd, "fc_mu", params["fc_mu"])
    _linblock(sd, "fc_logvar", params["fc_logvar"])
    return sd


def style_generator_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/style_gan.Generator params -> state_dict of the port's
    Generator; the inverse of torch_convert.style_generator_from_torch. The
    s2d head's final_c{0,1,2} hold the canonical (3, 3, C, F) kernels:
    final.{1,2,3}'s convs."""
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(("fc0", "fc1", "fc_out")):
        _linblock(sd, f"mlp.model.{i}", params["mlp"][name])
    for name in ("conv1", "conv2", "down1", "down2", "down3", "down4"):
        for branch in ("conv_1", "conv_2"):
            _convblock(sd, f"{name}.{branch}", params[name][branch])
    for i in (1, 2, 3):
        _convblock(sd, f"skip{i}", params[f"skip{i}"])
        up = params[f"up{i}"]
        _conv_transpose(sd, f"up{i}.up_convs.0", up["up"])
        _convblock(sd, f"up{i}.cat_convs.0", up["cat"])
        for j, scse in ((1, "scse0"), (2, "scse1")):
            for torch_name, jax_name in (("cSE.1", "cse_reduce"), ("cSE.3", "cse_expand"),
                                         ("sSE.0", "sse")):
                _conv_with_bias(sd, f"up{i}.cat_convs.{j}.{torch_name}", up[scse][jax_name])
    _conv_transpose(sd, "final.0", params["final_up"])
    for i in range(3):
        _conv_with_bias(sd, f"final.{i + 1}.conv.0", params[f"final_c{i}"])
    return sd


def style_discriminator_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX models/style_gan.Discriminator params -> state_dict of the port's
    Discriminator; the inverse of torch_convert.style_discriminator_from_torch.
    Its heads end on 1 x 1 maps: no flatten to permute. Style_GAN has no
    BatchNorm, so there are no running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(_levels(params) + 1):
        _convblock(sd, f"convs.{i}", params[f"c{i}"])
    for head in ("adv", "aux"):
        for i in range(2):
            _convblock(sd, f"{head}_convs.{i}", params[f"{head}{i}"])
    return sd
