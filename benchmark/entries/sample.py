"""Text -> images through the program's sampler (``make_sampler``): the
CLIP text tower, then the generator in eval mode, the stage tails through
K3 when the cell sets ``fused_tail``.  A call is done when its finest
images are on the host as uint8, as ``generate.py`` hands them to the
PNG writer (the writing itself is left out).

The check compares, for a few input batches drawn from the seed, the last
call of the window on each: every pyramid size's images against the
reference sampler on the same weights and inputs (the 64 and 128 px
images as the sampler returned them, the finest as the uint8 on the
host).  Readings: ``img_gap`` (the widest gap of the 64 and 128 px
images, on [-1, 1]), ``img_rms`` (their gaps' RMS over the reference's),
``u8_gap`` (the widest gap of the finest images, in counts) and
``u8_rms`` (the finest's gaps' RMS over the reference's distance from
127.5)."""

from __future__ import annotations

import torch

from benchmark import flops, session as S, traffic, yardstick
from benchmark.reference import exact, infer, nets

CHECKED = 2  # input batches compared


class Session:
    first_call = 0

    def __init__(self, cell, seed: int, device: torch.device):
        clock = S.SetupClock()
        from t2igan_torch.ops.image import uint8_from_tanh
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
        clock.lap("models")
        self.to_u8 = uint8_from_tanh
        self.batches = traffic.batches(tr, seed, device, w)
        clock.lap("traffic")
        self.checked = S.checked_batches(seed, len(self.batches), CHECKED)
        self.kept = {}
        stages = [((s, s), i == w["BRANCH_NUM"] - 2)
                  for i, s in enumerate(S.nets.pyramid(w)[:-1])]
        self.flops_per_call = flops.sample_call(w, cell.config["clip"],
                                                self.rows)
        self.k3_bound_ms = (yardstick.k3_bound_ms(
            self.rows, stages, 2 * w["GF_DIM"], w["R_NUM"],
            cell.dtype_name) if cell.fused_tail else None)
        self.launches_per_call = {
            "memory_read_fwd": w["BRANCH_NUM"] - 1,
            "reschain": (w["BRANCH_NUM"] - 1) if cell.fused_tail else 0}
        for i in range(2):  # the first call lays out K3's operands
            self.call(i)
        self.kept.clear()
        clock.lap("warm-up (2 calls; the kernels' load or build)")

    def call(self, i: int) -> None:
        bi = i % len(self.batches)
        b = self.batches[bi]
        fakes = self.sample(b["ids"], b["mask"], b["z"], b["eps"])
        host = self.to_u8(fakes[-1]).cpu()
        if bi in self.checked:
            self.kept[bi] = (fakes[:-1], host)

    def check(self, control=None):
        dev = self.device
        del self.sample, self.clip, self.gen
        S.free(dev)
        rclip, rgen, _ = S.reference_models(self.cell, self.weights, dev,
                                            self.dtype)
        diffs, refs, u8_diffs, u8_refs = [], [], [], []
        img_gap, u8_gap = 0.0, 0.0
        with exact():
            for bi, (small, host) in sorted(self.kept.items()):
                b = self.batches[bi]
                args = (b["ids"], b["mask"], b["z"], b["eps"])
                ref = infer.sample(rclip, rgen, *args, nets.Numerics())
                if control:
                    out = infer.sample(rclip, rgen, *args,
                                       nets.Numerics(control))
                    small, host = out[:-1], S.u8(out[-1]).cpu()
                for p, r in zip(small, ref[:-1]):
                    d = p.float() - r
                    img_gap = max(img_gap, float(d.abs().max()))
                    diffs.append(d)
                    refs.append(r)
                r8 = S.u8(ref[-1]).cpu().to(torch.int32)
                d8 = host.to(torch.int32) - r8
                u8_gap = max(u8_gap, float(d8.abs().max()))
                u8_diffs.append(d8)
                u8_refs.append(r8 - 127.5)
        return {"img_gap": img_gap, "img_rms": S.rel_rms(diffs, refs),
                "u8_gap": u8_gap, "u8_rms": S.rel_rms(u8_diffs, u8_refs)}
