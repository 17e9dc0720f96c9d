"""Manga-page BE inference CLI -- port of vaeplay_tpu/cli/test_be_manga.py
(rebuild of the reference test_BE_manga.py).

    python -m vaeplay_torch.cli.test_be_manga --path MANGA --anno_path ANNO \\
        --model_path logs/BE/<timestamp> --gpu 0
    python -m vaeplay_torch.cli.test_be_manga --path MANGA --debug --device cpu

Walks <path>/<manga>/<episode>/<chapter>/OriginSizeManga/<page>. A page with
a labelme file <anno_path>/<manga>/<episode>/<chapter>/<stem>.json takes the
annotation route; otherwise, with a coarse mask beside it in
OriginSizeBubbles/, the mask route; otherwise it is skipped. The bubbles of
each page are cropped on the host, predicted on the device as bit-packed
masks (eval/predictor.py) and pasted back at page resolution into
<res_output>/<manga>_<episode>_<chapter>_<stem>.png, the pages pipelined
through eval/serve.py:serve_pages. `--model_path` is read as test_be reads
it (a run dir, `<run dir>/<epoch>`, a checkpoint or a state_dict);
`--debug` serves the seed-0 init. Runs on `cuda:<--gpu>`; `--device cpu`
runs on the CPU. `--dtype bfloat16` runs the forward under bf16 autocast.
"""

import argparse
import os
from typing import List, Optional

from vaeplay_torch.cli.test_be import load_model
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.predictor import make_packed_be_predict
from vaeplay_torch.eval.serve import PageJob, ServeStats, serve_pages
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.viz import makedirs


def page_jobs(root: str, anno_root: Optional[str], annotated_only: bool = False) -> List[PageJob]:
    """The pages under root's manga/episode/chapter/OriginSizeManga folders:
    the annotation route where anno_root holds the page's JSON, else the
    mask route where OriginSizeBubbles holds its coarse mask (reference
    main_mask, test_BE_manga.py:386-396), else none. annotated_only keeps
    the annotated pages only (test_BE_GAN_manga.py)."""
    jobs = []
    for manga in sorted(os.listdir(root)):
        m_path = os.path.join(root, manga)
        if not os.path.isdir(m_path):
            continue
        for epi in sorted(os.listdir(m_path)):
            e_path = os.path.join(m_path, epi)
            for chapter in sorted(os.listdir(e_path)):
                c_path = os.path.join(e_path, chapter, "OriginSizeManga")
                if not os.path.isdir(c_path):
                    continue
                for pagef in sorted(os.listdir(c_path)):
                    stem = pagef.split(".")[0]
                    anno = mask = None
                    if anno_root:
                        cand = os.path.join(anno_root, manga, epi, chapter, f"{stem}.json")
                        anno = cand if os.path.exists(cand) else None
                    if anno is None:
                        cand = os.path.join(e_path, chapter, "OriginSizeBubbles", pagef)
                        if annotated_only or not os.path.exists(cand):
                            continue
                        mask = cand
                    jobs.append(PageJob(os.path.join(c_path, pagef), anno, mask,
                                        f"{manga}_{epi}_{chapter}_{stem}"))
    return jobs


def main(argv=None) -> ServeStats:
    """Run the CLI; returns (and prints) the ServeStats."""
    parser = argparse.ArgumentParser(description="manga-page BE inference (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", required=True,
                        help="manga root folder (manga/episode/chapter layout)")
    parser.add_argument("--anno_path", type=str, dest="anno_path", default=None)
    parser.add_argument("--model_path", type=str, dest="model_path", default=None)
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results/manga")
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the forward; the pasted masks are "
                             "thresholded at 0.5 either way")
    args = parser.parse_args(argv)
    if not args.debug and not args.model_path:
        parser.error("--model_path required unless --debug")
    device = resolve_device(args.gpu, args.device)
    makedirs(args.res_output)
    model = load_model(None if args.debug else args.model_path, device)
    predict = make_packed_be_predict(model, args.img_size,
                                     compute_dtype=resolve_dtype(args.dtype))
    stats = serve_pages(predict, page_jobs(args.path, args.anno_path), args.img_size,
                        args.res_output)
    print(f"pages written {stats.written}, empty {stats.empty}, failed {stats.failed}")
    return stats


if __name__ == "__main__":
    main()
