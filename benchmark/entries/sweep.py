"""The generation + R-precision sweep, batch by batch, as
``CondGanTrainer.sampling`` does it without writing PNGs: the plain-tail
sampler on the served copies of CLIP and G, the finest images resized to
CLIP's input (``nearest-exact``), and the rank function
(``make_rank_fn``) scoring each image against its true caption and the
other-class captions drawn for it on the host.  A call is done when the
batch's hits and scores are on the host.

The check compares a sample of the window's calls, drawn from the seed:
the program's scores against the reference's on the same images' inputs
and the same captions (``score_gap``, the widest), and its hits wherever
the reference's margin is wider than twice the scores' limit
(``hit_gap``, rows that disagree)."""

from __future__ import annotations

import torch

from benchmark import flops, session as S, traffic
from benchmark.reference import exact, infer, nets

KEPT = 4  # calls compared


class Session:
    first_call = 0

    def __init__(self, cell, seed: int, device: torch.device):
        clock = S.SetupClock()
        from t2igan_torch.evaluation.rprecision import make_rank_fn
        from t2igan_torch.ops.image import resize_nearest
        from t2igan_torch.train.steps import make_sampler

        S.check_tf32(cell.config)
        self.cell, self.seed, self.device = cell, seed, device
        w = cell.config["widths"]
        tr = cell.traffic
        self.dtype = S.DTYPES[cell.dtype_name]
        self.rows = tr["batch"]
        cfg = S.program_cfg(cell, False, self.rows)
        clock.lap("import")
        S.cuda_context(device)
        clock.lap("CUDA context")
        self.weights = S.make_weights(cell, seed, device)
        clock.lap("weights")
        self.clip, self.gen = S.served_models(cell, cfg, self.weights,
                                              self.dtype, device)
        self.sample = make_sampler(cfg, self.clip, self.gen)
        self.rank = make_rank_fn(self.clip)
        self.resize = resize_nearest
        self.size = self.clip.cfg.image_size
        clock.lap("models")
        self.batches = traffic.batches(tr, seed, device, w)
        self.classes = [b["class_ids"].cpu().numpy() for b in self.batches]
        self.mis = traffic.MisCaptions(tr, seed, w)
        clock.lap("traffic")
        self.kept = S.Reservoir(seed, KEPT)
        self.flops_per_call = flops.sweep_call(
            w, cell.config["clip"], self.rows, tr["mis_captions"])
        self.k3_bound_ms = None
        self.launches_per_call = {"memory_read_fwd": w["BRANCH_NUM"] - 1,
                                  "reschain": 0}
        self.call(0)
        self.kept = S.Reservoir(seed, KEPT)
        clock.lap("warm-up (1 call; the kernels' load or build)")

    def call(self, i: int) -> None:
        bi = i % len(self.batches)
        b = self.batches[bi]
        finest = self.sample(b["ids"], b["mask"], b["z"], b["eps"])[-1]
        mis_ids, mis_mask = self.mis.draw(self.classes[bi])
        resized = self.resize(finest, self.size).contiguous()
        with torch.profiler.record_function("bench.rank"):
            flags, scores = self.rank(resized, b["ids"], b["mask"], mis_ids,
                                      mis_mask)
            flags, scores = flags.cpu(), scores.cpu()
        self.kept.offer(lambda: (bi, mis_ids, mis_mask, flags, scores))

    def check(self, control=None):
        dev = self.device
        del self.sample, self.rank, self.clip, self.gen
        S.free(dev)
        rclip, rgen, _ = S.reference_models(self.cell, self.weights, dev,
                                            self.dtype)
        limit = self.cell.limits["score_gap"]
        score_gap, hit_gap = 0.0, 0
        with exact():
            for bi, mis_ids, mis_mask, flags, scores in self.kept.items:
                b = self.batches[bi]
                mis = (torch.as_tensor(mis_ids, device=dev),
                       torch.as_tensor(mis_mask, device=dev))

                def scored(n):
                    img = infer.sample(rclip, rgen, b["ids"], b["mask"],
                                       b["z"], b["eps"], n)[-1]
                    img = nets.resize_nearest(img, self.size)
                    return infer.rank_scores(rclip, img, b["ids"], b["mask"],
                                             *mis, n).cpu()

                ref = scored(nets.Numerics())
                if control:
                    scores = scored(nets.Numerics(control))
                    flags = scores.argmax(-1) == 0
                score_gap = max(score_gap,
                                float((scores.float() - ref).abs().max()))
                top2 = ref.topk(2, dim=-1).values
                clear = (top2[:, 0] - top2[:, 1]) > 2 * limit
                hit_gap += int(((flags != (ref.argmax(-1) == 0))
                                & clear).sum())
        return {"score_gap": score_gap, "hit_gap": float(hit_gap)}
