"""Pipelined manga-page serving -- the port's own copy of the page walker in
vaeplay_tpu/eval/serve.py (:29-143; the production form of the reference's
page loop, test_BE_manga.py:414-462, which loads, predicts and pastes one
page after another).

`serve_pages` overlaps the three stages across pages: loader threads decode
and crop the pages ahead, one dispatch thread makes every device call, in
page order, and paster threads paste and encode the PNGs. Pages are
independent (a per-sample model, a per-page paste), so every page's file is
the one the sequential loop writes; only the wall time changes.

The dispatch thread is a new thread, and a new thread's current CUDA device
is device 0: the predictor it calls must select its own device
(eval/predictor.py:on_device does).

`pipeline_bc_batches` (JAX :146-196) skews BC's two device programs and the
host contour trace between them across consecutive batches.
"""

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from vaeplay_torch.eval.manga import (load_manga_from_annotation, load_manga_from_mask,
                                      paste_edge_result_on_manga, paste_result_on_manga)

LOAD_WORKERS = 4   # threads that decode and crop pages ahead
PASTE_WORKERS = 4  # threads that paste and encode the PNGs


class PageJob(NamedTuple):
    """One page to serve. `anno_path` selects the labelme-annotation route
    (reference main_annotation, test_BE_manga.py:414-462); otherwise
    `mask_path` selects the connected-components mask route (main_mask
    :373-412)."""
    img_path: str
    anno_path: Optional[str]
    mask_path: Optional[str]
    name: str


def load_page(job: PageJob, img_size: int) -> Dict:
    if job.anno_path:
        return load_manga_from_annotation(job.img_path, job.anno_path, img_size)
    return load_manga_from_mask(job.img_path, job.mask_path, img_size)


def paste_page(job: PageJob, page: Dict, preds: Dict, res_output: str) -> None:
    """The annotation route pastes the predicted masks and edges; the mask
    route the predicted edges on the page's own coarse masks."""
    if job.anno_path:
        paste_result_on_manga(job.img_path, page, np.asarray(preds["masks"]),
                              np.asarray(preds["edges"]), res_output, job.name)
    else:
        paste_edge_result_on_manga(job.img_path, page, np.asarray(preds["edges"]), res_output,
                                   job.name)


class ServeStats(NamedTuple):
    """serve_pages' outcome."""
    written: int
    empty: int   # pages that loaded but hold no bubble
    failed: int  # pages skipped on a load, predict or paste error


def serve_pages(predict: Callable, jobs: Sequence[PageJob], img_size: int,
                res_output: str) -> ServeStats:
    """Every job through load -> predict -> paste, the stages overlapped:

      load    LOAD_WORKERS threads decode, crop and resize pages ahead (a
              window of LOAD_WORKERS + 2 pages, so memory stays bounded);
      predict one dispatch thread makes every `predict(crops)` call, in
              page order;
      paste   PASTE_WORKERS threads wait for their page's prediction, then
              paste at page resolution and encode the PNG (PIL and zlib
              release the interpreter lock).

    A page that fails to load, predict or paste is skipped with a message
    (the reference's blanket except, test_BE_manga.py:460-461); a page with
    no bubble is counted apart. Returns ServeStats(written, empty, failed)."""
    n_done = n_empty = n_failed = 0

    def paste_task(job, page, fut):
        paste_page(job, page, fut.result(), res_output)
        print(f"{job.name}: {page['images'].shape[0]} bubbles -> "
              f"{os.path.join(res_output, job.name)}.png")

    with ThreadPoolExecutor(max_workers=LOAD_WORKERS) as lp, \
            ThreadPoolExecutor(max_workers=1) as dp, \
            ThreadPoolExecutor(max_workers=PASTE_WORKERS) as pp:
        jobs_it = iter(jobs)
        window = LOAD_WORKERS + 2
        load_q: deque = deque()   # (job, load future), in submission order
        paste_q: deque = deque()  # (job, paste future)

        def fill_loads():
            while len(load_q) < window:
                job = next(jobs_it, None)
                if job is None:
                    return
                load_q.append((job, lp.submit(load_page, job, img_size)))

        def collect_paste(item):
            nonlocal n_done, n_failed
            job, fut = item
            try:
                fut.result()
                n_done += 1
            except Exception as e:  # a bad page is skipped (test_BE_manga.py:460)
                n_failed += 1
                print(f"skip {job.img_path}: {e}")

        fill_loads()
        while load_q:
            job, lf = load_q.popleft()
            fill_loads()
            try:
                page = lf.result()
            except Exception as e:
                n_failed += 1
                print(f"skip {job.img_path}: {e}")
                continue
            if page["images"].shape[0] == 0:
                n_empty += 1
                print(f"{job.name}: no bubbles found")
                continue
            fut = dp.submit(predict, page["images"])
            paste_q.append((job, pp.submit(paste_task, job, page, fut)))
            while len(paste_q) > 2 * PASTE_WORKERS:
                collect_paste(paste_q.popleft())
        while paste_q:
            collect_paste(paste_q.popleft())
    return ServeStats(n_done, n_empty, n_failed)


def pipeline_bc_batches(dispatch_mask: Callable, submit_trace: Callable,
                        dispatch_refine: Callable, batches: Iterable
                        ) -> Iterator[Tuple[object, object]]:
    """BC served as mask program -> host contour trace -> refine program
    (reference networks_BC.py:208-241, where the trace sits between the two
    device passes), the stages skewed across batches so that batch i-1's
    trace and batch i-2's output fetch overlap batch i's mask pass:

        dispatch order:  mask(0) | mask(1), refine(0) | mask(2), refine(1),
                         yield(0) | mask(3), refine(2), yield(1) | ...

    Every device call stays on the caller's thread; only the packed mask's
    copy and the trace run on the tracer's worker thread (`submit_trace`,
    e.g. BridgeTracer.submit).

      dispatch_mask:   batch -> the packed mask on the device
      submit_trace:    packed -> Future of (pts, counts)
      dispatch_refine: (batch, pts, counts) -> the refine output
      batches:         iterable of model inputs

    Yields (batch, refine output) in order, one batch behind the dispatch
    front. Batches are independent, so the results are the sequential
    loop's; only the wall time changes."""
    tq: deque = deque()  # (batch, trace future): mask dispatched
    rq: deque = deque()  # (batch, refine output): refine dispatched

    def advance():
        x, tf = tq.popleft()
        pts, counts = tf.result()
        rq.append((x, dispatch_refine(x, pts, counts)))

    for x in batches:
        tq.append((x, submit_trace(dispatch_mask(x))))
        if len(tq) >= 2:
            advance()
        while len(rq) >= 2:
            yield rq.popleft()
    while tq:
        advance()
    while rq:
        yield rq.popleft()
