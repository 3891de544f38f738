"""The plain reference of the adversarial train step, in f32.

Copied, frozen, from the port at commit c2e05f1: ``t2igan_torch/train/
steps.py::make_gan_step`` (one process, no mesh, no autocast),
``train/state.py`` (Adam with betas (0.5, 0.999) and eps 1e-8, the EMA of
G's parameters with its buffers copied).  It imports nothing of the port.

The noise of each step is drawn as the port's step draws it from the
generator it is handed: ``z`` [B, Z_DIM], then ``eps1`` and ``eps2``
[B, CONDITION_DIM], standard normal on the generator's device.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import torch

from benchmark.reference import losses as L
from benchmark.reference.nets import Numerics, l2_normalize, resize_nearest


def gan_steps(clip, gen, ds, batches: List[dict], noise: torch.Generator,
              train_cfg: dict, widths: dict, n: Numerics) -> dict:
    """Run ``len(batches)`` steps from the modules' current weights.

    Returns ``losses`` (per step: ``g_loss`` and ``d_loss<i>``),
    ``grads`` (every G and D parameter's gradient at the first step, by
    leaf name ``gen.<name>`` / ``d<i>.<name>``) and ``params`` (every
    parameter after the last step, with the EMA's as ``ema.<name>``)."""
    sm = train_cfg["SMOOTH"]
    g1, g2, g3, lam = sm["GAMMA1"], sm["GAMMA2"], sm["GAMMA3"], sm["LAMBDA"]
    decay = train_cfg["EMA_DECAY"]
    ema = copy.deepcopy(gen).requires_grad_(False)
    clip.requires_grad_(False)

    def adam(params, lr):
        return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8,
                                foreach=False)

    g_opt = adam(gen.parameters(), train_cfg["GENERATOR_LR"])
    d_opts = [adam(d.parameters(), train_cfg["DISCRIMINATOR_LR"])
              for d in ds]
    size = clip.cfg.image_size
    out = {"losses": [], "grads": {}}
    for step, batch in enumerate(batches):
        ids, mask = batch["ids"], batch["mask"]
        ids2, mask2 = batch["ids_2"], batch["mask_2"]
        cls = batch["class_ids"]
        images = [x.float() for x in batch["images"]]
        b = ids.shape[0]
        dev = noise.device
        z = torch.randn((b, widths["Z_DIM"]), generator=noise, device=dev)
        eps1 = torch.randn((b, widths["CONDITION_DIM"]), generator=noise,
                           device=dev)
        eps2 = torch.randn((b, widths["CONDITION_DIM"]), generator=noise,
                           device=dev)
        with torch.no_grad():
            words, sent = clip.encode_text(torch.cat([ids, ids2]),
                                           torch.cat([mask, mask2]), n)
        words1, words2 = words.chunk(2)
        sent1, sent2 = sent.chunk(2)
        f1, mu1, lv1 = gen(z, sent1, words1, mask == 0, eps1, True, n)
        f2, mu2, lv2 = gen(z, sent2, words2, mask2 == 0, eps2, True, n)
        wrong1, wrong2 = torch.roll(sent1, -1, 0), torch.roll(sent2, -1, 0)
        losses = {}
        for i, (d, opt) in enumerate(zip(ds, d_opts)):
            x = torch.cat([images[i], f1[i].detach(), f2[i].detach()])
            h_r, h_f1, h_f2 = d.trunk(x, True, n).chunk(3)

            def cond(h, c, d=d):
                return d.cond_head(h, c, n)

            def uncond(h, d=d):
                return d.uncond_head(h, None, n)

            loss = (L.d_loss(cond(h_r, sent1), cond(h_f1, sent1),
                             cond(h_r, wrong1), uncond(h_r), uncond(h_f1))
                    + L.d_loss(cond(h_r, sent2), cond(h_f2, sent2),
                               cond(h_r, wrong2), uncond(h_r),
                               uncond(h_f2)))
            params = list(d.parameters())
            for (name, p), g in zip(d.named_parameters(),
                                    torch.autograd.grad(loss, params)):
                p.grad = g
                if step == 0:
                    out["grads"][f"d{i}.{name}"] = g.detach().clone()
            opt.step()
            losses[f"d_loss{i}"] = float(loss.detach())
        sent12 = torch.cat([sent1, sent2])
        adv = 0.0
        for i, d in enumerate(ds):
            h = d.trunk(torch.cat([f1[i], f2[i]]), False, n)
            adv = adv + 2.0 * (L.bce(d.cond_head(h, sent12, n), 1.0)
                               + L.bce(d.uncond_head(h, None, n), 1.0))
        regions, cnn = clip.encode_image(
            resize_nearest(torch.cat([f1[-1], f2[-1]]), size), n)
        regions1, regions2 = regions[:, 1:].chunk(2)
        cnn1, cnn2 = cnn.chunk(2)
        total = adv
        for reg, code, w, m, s in ((regions1, cnn1, words1, mask, sent1),
                                   (regions2, cnn2, words2, mask2, sent2)):
            w0, w1 = L.words_loss(reg, w, cls, m > 0, g1, g2, g3)
            s0, s1 = L.sent_loss(code, s, cls, g3)
            total = total + (w0 + w1) * lam + (s0 + s1) * lam
        total = (total + L.kl_loss(mu1, lv1) + L.kl_loss(mu2, lv2)
                 + 0.2 * L.nt_xent(l2_normalize(cnn1), l2_normalize(cnn2)))
        params = list(gen.parameters())
        for (name, p), g in zip(gen.named_parameters(),
                                torch.autograd.grad(total, params)):
            p.grad = g
            if step == 0:
                out["grads"][f"gen.{name}"] = g.detach().clone()
        g_opt.step()
        with torch.no_grad():
            for e, p in zip(ema.parameters(), gen.parameters()):
                e.copy_(decay * e + (1.0 - decay) * p)
            for e, buf in zip(ema.buffers(), gen.buffers()):
                e.copy_(buf)
        losses["g_loss"] = float(total.detach())
        out["losses"].append(losses)
    params: Dict[str, torch.Tensor] = {}
    for prefix, mod in [("gen", gen), ("ema", ema),
                        *((f"d{i}", d) for i, d in enumerate(ds))]:
        for name, p in mod.named_parameters():
            params[f"{prefix}.{name}"] = p.detach()
    out["params"] = params
    return out
