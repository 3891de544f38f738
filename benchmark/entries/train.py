"""Adversarial training through the program's trainer: ``CondGanTrainer``
builds CLIP, G, the discriminators, the train state and its noise
generator; the window calls its ``step_fn`` on the device-resident
batches back to back, each step's metrics read to the host as
``train_steps`` reads them.

Set-up loads the benchmark's weights into that trainer and drives its
first three steps through the window's own call, on batches whose rows
all differ.  The check follows those three steps with the reference from
the same weights, batches and noise: each step's losses, the first
step's gradient of every leaf (as Adam holds it after one step), and each
leaf's change over the three steps.  Readings: ``loss_gap`` (the widest
relative gap of ``g_loss`` and each ``d_loss<i>`` over the three steps),
``loss_gap_first`` (the same at the first step), ``grad_gap`` and
``change_gap`` (the worst leaf's gap between the two norms, against the
reference's norm of that leaf or of the median leaf, whichever is
larger), ``grad_gap_median`` and ``change_gap_median`` (the median
leaf's gap)."""

from __future__ import annotations

import sys

import torch

from benchmark import flops, session as S, traffic
from benchmark.reference import exact, nets
from benchmark.reference.train import gan_steps

CHECKED_STEPS = 3
WARM_STEPS = 2  # after the checked ones, before the window
# Leaves whose reference gradient is under this share of the median
# leaf's move under Adam by rounding alone; their change is not compared.
DEAD_GRAD = 1e-3


class Session:
    first_call = CHECKED_STEPS + WARM_STEPS

    def __init__(self, cell, seed: int, device: torch.device):
        clock = S.SetupClock()
        from t2igan_torch.train.train_gan import CondGanTrainer

        S.check_tf32(cell.config)
        self.cell, self.seed, self.device = cell, seed, device
        w = cell.config["widths"]
        tr = cell.traffic
        self.rows = tr["batch"]
        cfg = S.program_cfg(cell, True, self.rows)
        clock.lap("import")
        self.trainer = t = CondGanTrainer(
            cfg, str(device), S.DTYPES[cell.dtype_name], seed=0,
            clip_cfg=S.clip_config(cell))
        clock.lap("trainer (models built and initialised on the host)")
        self.weights = S.make_weights(cell, seed, device)
        S.load(t.clip, S.part(self.weights, "clip."))
        S.load(t.state.gen, S.part(self.weights, "gen."))
        S.load(t.state.gen_ema, S.part(self.weights, "gen."))
        for i, d in enumerate(t.state.ds):
            S.load(d, S.part(self.weights, f"d{i}."))
        t.noise.manual_seed(traffic.derive(seed, 2))
        clock.lap("weights")
        self.batches = traffic.batches(tr, seed, device, w)
        clock.lap("traffic")
        if len(self.batches) < CHECKED_STEPS:
            raise ValueError("the check needs a distinct batch a step")
        self.flops_per_call = flops.train_step(w, cell.config["clip"],
                                               self.rows)
        self.k3_bound_ms = None
        stages = w["BRANCH_NUM"] - 1
        self.launches_per_call = {"memory_read_fwd": 2 * stages,
                                  "memory_read_bwd": 2 * stages,
                                  "reschain": 0}
        self.losses = []
        self.call(0)
        self.grads = self._first_grads()
        for i in range(1, CHECKED_STEPS):
            self.call(i)
        self.changes = self._changes()
        self.recording = False
        for i in range(CHECKED_STEPS, self.first_call):
            self.call(i)
        clock.lap("warm-up (5 steps, the first 3 checked; the kernels' load or build)")

    recording = True

    def call(self, i: int) -> None:
        t = self.trainer
        out = t.step_fn(t.state, self.batches[i % len(self.batches)],
                        generator=t.noise)
        metrics = {k: float(v) for k, v in out.items()}
        if self.recording:
            self.losses.append(metrics)

    def _modules(self):
        s = self.trainer.state
        return [("gen", s.gen, s.g_opt)] + [
            (f"d{i}", d, o) for i, (d, o) in enumerate(zip(s.ds, s.d_opts))]

    @torch.no_grad()
    def _first_grads(self):
        """Each leaf's gradient norm at the first step, from Adam's first
        moment after one step, ``(1 - beta1) g``."""
        out = {}
        for prefix, mod, opt in self._modules():
            beta1 = opt.param_groups[0]["betas"][0]
            for name, p in mod.named_parameters():
                m = opt.state.get(p, {}).get("exp_avg")
                out[f"{prefix}.{name}"] = (
                    0.0 if m is None else float(m.norm()) / (1 - beta1))
        return out

    @torch.no_grad()
    def _changes(self):
        """Each leaf's parameters minus the weights the benchmark loaded."""
        s = self.trainer.state
        mods = [(p, m) for p, m, _ in self._modules()] + [("ema", s.gen_ema)]
        out = {}
        for prefix, mod in mods:
            src = "gen" if prefix == "ema" else prefix
            for name, p in mod.named_parameters():
                start = self.weights[f"{src}.{name}"]
                out[f"{prefix}.{name}"] = float((p - start).norm())
        return out

    def check(self, control=None):
        dev = self.device
        prog_losses, prog_grads, prog_changes = (
            self.losses[:CHECKED_STEPS], self.grads, self.changes)
        del self.trainer
        S.free(dev)
        tcfg = dict(self.cell.config["train"])

        def follow(n):
            rclip, rgen, rds = S.reference_models(self.cell, self.weights,
                                                  dev)
            noise = torch.Generator(device=dev).manual_seed(
                traffic.derive(self.seed, 2))
            with exact():
                out = gan_steps(rclip, rgen, rds,
                                self.batches[:CHECKED_STEPS], noise, tcfg,
                                self.cell.config["widths"], n)
            grads = {k: float(v.norm()) for k, v in out["grads"].items()}
            changes = {k: float((v - self.weights[
                "gen." + k[4:] if k.startswith("ema.") else k]).norm())
                for k, v in out["params"].items()}
            return out["losses"], grads, changes

        ref_losses, ref_grads, ref_changes = follow(nets.Numerics())
        if control:
            prog_losses, prog_grads, prog_changes = follow(
                nets.Numerics(control))
        gaps = [{k: abs(p[k] - r[k]) / abs(r[k]) for k in r}
                for p, r in zip(prog_losses, ref_losses)]
        grads = S.norm_gaps(prog_grads, ref_grads)
        med = S.median(ref_grads.values())
        live = [k for k in ref_changes
                if ref_grads["gen." + k[4:] if k.startswith("ema.") else k]
                >= DEAD_GRAD * med]
        changes = S.norm_gaps(prog_changes, ref_changes, live)
        grad_gap, grad_at = S.worst(grads)
        change_gap, change_at = S.worst(changes)
        print("loss gaps by step: " + "; ".join(
            ", ".join(f"{k} {v:.3g}" for k, v in g.items()) for g in gaps),
            file=sys.stderr)
        print(f"worst leaves: gradient {grad_at}, change {change_at}; "
              f"{len(ref_changes) - len(live)} of {len(ref_changes)} leaves "
              "left out of the change (reference gradient under "
              f"{DEAD_GRAD} of the median leaf's)", file=sys.stderr,
              flush=True)
        return {"loss_gap": max(max(g.values()) for g in gaps),
                "loss_gap_first": max(gaps[0].values()),
                "grad_gap": grad_gap, "change_gap": change_gap,
                "grad_gap_median": S.median(grads.values()),
                "change_gap_median": S.median(changes.values())}
