"""Batches for the port's trainers: fixed-shape collate, the loader and the
device feed (the port's counterpart of :mod:`t2igan.data.pipeline`).

:class:`DataLoader` shuffles epoch ``e`` by ``numpy.random.default_rng((seed,
e))`` (epochs count from 1, as the JAX loader's), drops the last partial
batch and keeps ``prefetch + 1`` batches in flight.  Every random decision
of a sample (crop, flip, both captions) is drawn on the calling thread, in
index order, before its pixels are made; the workers only decode and
transform.  So the records of a seed do not depend on the number of
workers or on their timing:

* ``engine="native"`` (and ``"auto"`` for a dataset with plans): the
  JAX native engine's draws (``plan_record``) and its C++ executor, copied
  (:class:`t2igan_torch.data.native.AsyncExecutor`);
* ``engine="thread"``: the JAX thread engine's draws (``__getitem__``'s
  integer crops, sized from the image headers) and a pool of Python threads,
  each sample one call into the host library with the interpreter lock
  released;
* a dataset without plans (the synthetic one) is read record by record on
  the threads, as the JAX thread engine reads it.

A sample that cannot be read or decoded raises
:class:`t2igan_torch.data.native.DecodeError` with its file and error code;
the JAX package hands such samples to PIL, which the port does not have.

Each :class:`Batch` carries the dataset generator's state just after its
own draws (``rng_state``), so that a run stopped after any batch resumes
with the draws an unstopped run would make, whatever was prefetched.

Under data parallelism (PARITY D11) host ``host_index`` of ``host_count``
takes the ``host_index``-th contiguous slab of every epoch's order (the
JAX loader's ``_host_slice``) and batches ``batch_size`` records of it;
its local rank ``local_index`` of ``local_count`` then takes its
contiguous ``batch_size / local_count`` rows of each host batch.  Every
local rank draws the plans of the whole host batch from the dataset's one
generator, in the loader's order, and decodes only its own rows: a rank
that drew only its own rows would shift every later crop, flip and
caption.  A dataset without plans (the synthetic one) is read record by
record, each a function of its index, so a rank reads only its own.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from t2igan_torch.data import native
from t2igan_torch.data.tokenizer import ClipTokenizer


@dataclass
class Batch:
    """One fixed-shape batch (two caption views per image).  ``images`` is
    per branch [B, s, s, 3] float32 (numpy, or pinned CPU tensors for a
    loader with ``pin_memory``), or None for a batch drawn without pixels."""

    images: Optional[List[Any]]
    input_ids: np.ndarray               # [B, W] int32, view 1
    attention_mask: np.ndarray          # [B, W] int32
    input_ids_2: np.ndarray             # [B, W] int32, view 2
    attention_mask_2: np.ndarray        # [B, W]
    class_ids: np.ndarray               # [B] int32
    keys: List[str]
    rng_state: Optional[Dict] = field(default=None, repr=False)

    def arrays(self, finest_only: bool = False) -> Dict[str, Any]:
        """The train steps' batch: ``images`` (every branch, or the finest
        alone), ``ids``, ``mask``, ``ids_2``, ``mask_2``, ``class_ids``."""
        out = {"ids": self.input_ids, "mask": self.attention_mask,
               "ids_2": self.input_ids_2, "mask_2": self.attention_mask_2,
               "class_ids": self.class_ids}
        if self.images is not None:
            out["images"] = self.images[-1] if finest_only else \
                list(self.images)
        return out


def _tokens(tokenizer: ClipTokenizer, words_num: int, captions: List[str],
            captions_2: List[str]):
    caps1 = tokenizer(captions, max_length=words_num)
    caps2 = tokenizer(captions_2, max_length=words_num)
    return dict(input_ids=caps1["input_ids"],
                attention_mask=caps1["attention_mask"],
                input_ids_2=caps2["input_ids"],
                attention_mask_2=caps2["attention_mask"])


def collate(records, tokenizer: ClipTokenizer, words_num: int,
            with_images: bool = True) -> Batch:
    """Tokenize both caption views and stack the pyramid (the mask-based
    ``prepare_data``, datasets.py:28-81)."""
    images = None
    if with_images:
        images = [np.stack([r.images[b] for r in records]).astype(np.float32)
                  for b in range(len(records[0].images))]
    return Batch(images=images,
                 class_ids=np.asarray([r.class_id for r in records],
                                      np.int32),
                 keys=[r.key for r in records],
                 **_tokens(tokenizer, words_num,
                           [r.caption for r in records],
                           [r.caption_2 for r in records]))


def _to_device(x, device: torch.device):
    if isinstance(x, (list, tuple)):
        return [_to_device(v, device) for v in x]
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or torch.is_tensor(x)


def put_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A train step's batch dict on ``device``: each array (or list of
    arrays) on a CUDA device from pinned host memory with ``non_blocking``
    copies, on the CPU as plain tensors; other entries as they are."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if _is_array(v) or (isinstance(v, list) and v
                            and all(map(_is_array, v))):
            out[k] = _to_device(v, device)
        else:
            out[k] = v
    return out


def prefetch_to_device(batch_iter: Iterable[Dict[str, Any]], device,
                       depth: int = 2) -> Iterator[Dict[str, Any]]:
    """Keep ``depth`` batches already on their way to ``device`` ahead of
    the consumer (:func:`put_batch` on each), in order.  Closing it closes
    ``batch_iter``."""
    queue = collections.deque()
    it = iter(batch_iter)
    try:
        for batch in it:
            queue.append(put_batch(batch, device))
            if len(queue) > depth:
                yield queue.popleft()
        while queue:
            yield queue.popleft()
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


class DataLoader:
    """Shuffling, drop-last, prefetching batch iterator (the JAX package's
    ``DataLoader``).  ``pin_memory`` puts the images of each batch in
    pinned CPU tensors, ready for ``non_blocking`` copies.
    ``host_index``/``host_count`` and ``local_index``/``local_count`` split
    the data over hosts and their local ranks (the module's docstring);
    ``batch_size`` is the per-host batch and must divide over the local
    ranks."""

    def __init__(self, dataset, tokenizer: ClipTokenizer, batch_size: int,
                 words_num: int, shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 2, prefetch: int = 2, seed: int = 0,
                 engine: str = "auto", pin_memory: bool = False,
                 host_index: int = 0, host_count: int = 1,
                 local_index: int = 0, local_count: int = 1):
        if engine not in ("auto", "thread", "native"):
            raise ValueError(f"unknown loader engine {engine!r}")
        if batch_size % local_count:
            raise ValueError(f"a host batch of {batch_size} does not split "
                             f"over {local_count} local ranks")
        self.host_index, self.host_count = host_index, host_count
        self.local_index, self.local_count = local_index, local_count
        self.rows = batch_size // local_count  # this rank's rows a batch
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.words_num = words_num
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.engine = engine
        self.pin_memory = pin_memory
        self.epoch = 0  # epochs started; epoch e is ordered by (seed, e)
        self._exec: Optional[native.AsyncExecutor] = None

    def _host_slice(self, idx: np.ndarray) -> np.ndarray:
        """This host's contiguous slab of an epoch's order."""
        if self.host_count <= 1:
            return idx
        per = len(idx) // self.host_count
        return idx[self.host_index * per:(self.host_index + 1) * per]

    def _own(self, items: list) -> list:
        """This local rank's rows of a host batch's ``items``."""
        if self.local_count <= 1:
            return items
        start = self.local_index * self.rows
        return items[start:start + self.rows]

    def __len__(self):
        n = len(self._host_slice(np.arange(len(self.dataset))))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # ---- order ----

    def order(self, epoch: int) -> np.ndarray:
        """The sample order of epoch ``epoch``."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def next_order(self) -> np.ndarray:
        """Start the next epoch: its number, then its order."""
        self.epoch += 1
        return self.order(self.epoch)

    def index_batches(self, order: np.ndarray) -> List[np.ndarray]:
        """This host's batches of the epoch order ``order``."""
        order = self._host_slice(order)
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        return [order[s:s + self.batch_size]
                for s in range(0, stop, self.batch_size)]

    def __iter__(self) -> Iterator[Batch]:
        return self.batches(self.next_order())

    # ---- draws ----

    def engine_in_use(self) -> str:
        """``"native"``, ``"thread"`` or ``"records"`` (a dataset without
        plans, read record by record)."""
        has_plans = hasattr(self.dataset, "plan_record")
        if self.engine == "native" and not has_plans:
            raise RuntimeError(
                "engine='native' needs a dataset with plan_record() "
                f"(got {type(self.dataset).__name__})")
        if not has_plans:
            return "records"
        return "thread" if self.engine == "thread" else "native"

    def _rng_state(self):
        rng = getattr(self.dataset, "rng", None)
        return None if rng is None else rng.bit_generator.state

    def _draw(self, idxs, engine: str):
        """This rank's plans of one host batch, after drawing the whole
        batch's in index order; for a dataset without plans, this rank's
        records."""
        ds = self.dataset
        if engine == "records":
            return [ds[int(i)] for i in self._own(list(idxs))]
        plan = ds.plan_record if engine == "native" else ds.thread_plan
        return self._own([plan(int(i)) for i in idxs])

    def _batch(self, plans, images) -> Batch:
        return Batch(images=images,
                     class_ids=np.asarray([p.class_id for p in plans],
                                          np.int32),
                     keys=[p.key for p in plans],
                     rng_state=self._rng_state(),
                     **_tokens(self.tokenizer, self.words_num,
                               [p.caption for p in plans],
                               [p.caption_2 for p in plans]))

    def caption_batches(self) -> Iterator[Batch]:
        """The next epoch's batches with every draw that iterating the
        loader makes (so the dataset's generator moves exactly as it
        would), but without pixels: ``images`` is None."""
        engine = self.engine_in_use()
        for idxs in self.index_batches(self.next_order()):
            yield self._batch(self._draw(idxs, engine), None)

    def peek(self, with_images: bool = True,
             whole: bool = False) -> Optional[Batch]:
        """A fixed probe batch that moves neither the epoch nor the
        dataset's generator: the first ``batch_size`` records in dataset
        order through ``deterministic_record`` (first two captions, centre
        crop, no flip) where the dataset has it, else its records; this
        rank's rows of them, or all of them with ``whole``."""
        n = min(self.batch_size, len(self.dataset))
        if n == 0:
            return None
        ds = self.dataset
        idxs = list(range(n)) if whole else self._own(list(range(n)))
        if not hasattr(ds, "deterministic_plan"):
            return collate([ds[i] for i in idxs], self.tokenizer,
                           self.words_num, with_images)
        plans = [ds.deterministic_plan(i) for i in idxs]
        images = None
        if with_images:
            images = [np.stack(x) for x in zip(*map(ds.load_plan, plans))]
        batch = self._batch(plans, images)
        batch.rng_state = None
        return batch

    # ---- pixels ----

    def _alloc(self, n: int) -> List[Any]:
        shapes = [(n, s, s, 3) for s in self.dataset.sizes]
        if self.pin_memory:
            return [torch.empty(sh, dtype=torch.float32, pin_memory=True)
                    for sh in shapes]
        return [np.empty(sh, np.float32) for sh in shapes]

    def _get_exec(self) -> native.AsyncExecutor:
        """One executor, made at first use and kept across epochs (its slot
        buffers are large)."""
        if self._exec is None:
            ds = self.dataset
            self._exec = native.AsyncExecutor(
                branch_sizes=list(ds.sizes), scale_size=ds.transform.scale,
                crop=ds.transform.imsize, max_batch=self.rows,
                n_threads=self.num_workers, n_slots=self.prefetch + 1)
        return self._exec

    def close(self) -> None:
        """Release the executor (its threads and slot buffers)."""
        if self._exec is not None:
            self._exec.close()
            self._exec = None

    def batches(self, order: np.ndarray, start: int = 0) -> Iterator[Batch]:
        """The batches of ``order`` from batch ``start`` on, without moving
        the epoch (a resumed epoch goes on with this)."""
        index_batches = self.index_batches(order)[start:]
        if not index_batches:
            return iter(())
        engine = self.engine_in_use()
        if engine == "native":
            return self._iter_native(index_batches)
        return self._iter_threads(index_batches, engine)

    def _iter_native(self, index_batches) -> Iterator[Batch]:
        """Plans for ``prefetch + 1`` batches ahead go to the C++ executor;
        the loader blocks only on the oldest."""
        ex = self._get_exec()
        pending = collections.deque()
        it = iter(index_batches)
        ids = itertools.count()

        def submit_one() -> bool:
            idxs = next(it, None)
            if idxs is None:
                return False
            plans = self._draw(idxs, "native")
            bid = next(ids)
            uv = np.asarray([[p.u, p.v] for p in plans], np.float32)
            ex.submit(bid, [p.path for p in plans], [p.bbox for p in plans],
                      uv, [p.flip for p in plans])
            # tokenised at submit time, beside the decode
            pending.append((bid, self._batch(plans, None)))
            return True

        try:
            for _ in range(self.prefetch + 1):
                if not submit_one():
                    break
            while pending:
                bid, branches, errs = ex.wait()
                want, batch = pending.popleft()
                if bid != want:
                    raise RuntimeError(f"executor returned batch {bid}, "
                                       f"expected {want}")
                try:
                    ex.raise_errors(bid, errs)
                    images = self._alloc(len(batch.keys))
                    for dst, src in zip(images, branches):
                        if torch.is_tensor(dst):
                            dst.copy_(torch.from_numpy(src))
                        else:
                            dst[...] = src
                finally:
                    ex.release(bid)
                batch.images = images
                submit_one()
                yield batch
        finally:
            # Drain what is in flight (the consumer stopped early, or a
            # sample failed) so the executor starts the next epoch clean.
            while pending:
                bid, _, _ = ex.wait()
                pending.popleft()
                ex.release(bid)

    def _iter_threads(self, index_batches, engine: str) -> Iterator[Batch]:
        """Draws on this thread; one task per sample on ``num_workers``
        threads; ``prefetch + 1`` batches in flight."""
        ds = self.dataset
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            it = iter(index_batches)

            def submit_one() -> bool:
                idxs = next(it, None)
                if idxs is None:
                    return False
                drawn = self._draw(idxs, engine)
                if engine == "records":
                    pending.append((None, collate(drawn, self.tokenizer,
                                                  self.words_num)))
                    pending[-1][1].rng_state = self._rng_state()
                    return True
                batch = self._batch(drawn, None)
                batch.images = self._alloc(len(drawn))
                views = [[im[i].numpy() if torch.is_tensor(im) else im[i]
                          for im in batch.images] for i in range(len(drawn))]
                pending.append(([pool.submit(ds.load_plan, p, v)
                                 for p, v in zip(drawn, views)], batch))
                return True

            try:
                for _ in range(self.prefetch + 1):
                    if not submit_one():
                        break
                while pending:
                    futures, batch = pending.popleft()
                    for f in futures or ():
                        f.result()
                    submit_one()
                    yield batch
            finally:
                for futures, _ in pending:
                    for f in futures or ():
                        f.cancel()
