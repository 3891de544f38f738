"""Train and inference steps of the port (``t2igan.train.steps``): the
DAMSM CLIP fine-tuning step, the adversarial GAN step and the sampler."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from t2igan_torch.config import Config
from t2igan_torch.losses import (discriminator_loss, generator_adv_loss,
                                 kl_loss, nt_xent_loss, sent_loss,
                                 strip_special_tokens, words_loss,
                                 wrong_pair)
from t2igan_torch.models.clip import ClipWithRegionHead
from t2igan_torch.models.generator import GDCGan, GNet, global_batch_stats
from t2igan_torch.ops.attention import l2_normalize
from t2igan_torch.ops.image import resize_nearest
from t2igan_torch.parallel.mesh import DataMesh
from t2igan_torch.train.state import (DamsmOptimizer, GanTrainState,
                                      ema_update)


EMA_DECAY = 0.999  # the G EMA's mixing rate


def make_damsm_loss(cfg: Config, clip: ClipWithRegionHead,
                    dtype: torch.dtype = torch.float32,
                    mesh: Optional[DataMesh] = None
                    ) -> Callable[..., Tuple[torch.Tensor, Dict]]:
    """The DAMSM loss, as ``t2igan.train.steps.make_damsm_loss``:
    ``loss_fn(batch) -> (total, metrics)`` on ``clip``'s current weights.

    ``batch`` holds ``images`` [B, S, S, 3] (CLIP-normalised, S the
    tower's image size), ``ids``/``mask`` and ``ids_2``/``mask_2`` (the two
    caption views, mask 1 at real tokens) and ``class_ids``, as arrays or
    tensors.  The image tower runs once: the image code is l2-normalised
    (eps on the norm) and the regions are ``linear_subr`` of the patch
    states (CLS dropped).  Both caption views go through the text tower in
    one [2B] apply; the sentence vectors are l2-normalised, and <sos>/<eos>
    are stripped from each view's word states.  The total is 4
    ``words_loss`` terms (both directions, both views) + 4 ``sent_loss``
    terms + ``nt_xent_loss(sent1, sent2, 0.5)``; the metrics are
    ``loss``, ``w_loss``, ``s_loss`` and ``contrastive``.

    ``dtype=torch.bfloat16`` runs the towers under ``torch.autocast``; the
    losses are f32.

    Under a ``mesh`` with a group, ``batch`` holds this rank's rows; the
    towers run on them, and the word, sentence and NT-Xent terms are
    computed whole on every rank over the global batch (regions, image
    codes, words and sentences gathered with their autograd, the masks
    and class ids without), so ``total`` and the metrics are the global
    ones and the per-rank objectives sum to ``W`` times the global loss
    (:mod:`t2igan_torch.parallel.mesh`)."""
    mesh = mesh or DataMesh.single(clip.logit_scale.device)
    g1 = cfg.TRAIN.SMOOTH.GAMMA1
    g2 = cfg.TRAIN.SMOOTH.GAMMA2
    g3 = cfg.TRAIN.SMOOTH.GAMMA3

    def loss_fn(batch) -> Tuple[torch.Tensor, Dict]:
        device = clip.logit_scale.device

        def put(x):
            return torch.as_tensor(x, device=device)

        ids, mask = put(batch["ids"]), put(batch["mask"])
        ids2, mask2 = put(batch["ids_2"]), put(batch["mask_2"])
        cls = put(batch["class_ids"])
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            subr, img_code = clip.encode_image_verbose(
                put(batch["images"]).float())
            words12, sent12 = clip.encode_text_verbose(
                torch.cat([ids, ids2]), torch.cat([mask, mask2]))
        img_code = l2_normalize(img_code.float())
        regions = subr[:, 1:].float()
        words1, words2 = words12.float().chunk(2)
        sent1, sent2 = l2_normalize(sent12.float()).chunk(2)
        w1, m1 = strip_special_tokens(words1, mask)
        w2, m2 = strip_special_tokens(words2, mask2)
        live, rows = mesh.gather_rows_live, mesh.gather_rows
        regions, img_code = live(regions), live(img_code)
        w1, w2, sent1, sent2 = live(w1), live(w2), live(sent1), live(sent2)
        m1, m2, cls = rows(m1), rows(m2), rows(cls)

        wl0, wl1 = words_loss(regions, w1, cls, m1, g1, g2, g3)
        wl0b, wl1b = words_loss(regions, w2, cls, m2, g1, g2, g3)
        sl0, sl1 = sent_loss(img_code, sent1, cls, g3)
        sl0b, sl1b = sent_loss(img_code, sent2, cls, g3)
        contrast = nt_xent_loss(sent1, sent2, temperature=0.5)
        w_loss = wl0 + wl1 + wl0b + wl1b
        s_loss = sl0 + sl1 + sl0b + sl1b
        total = w_loss + s_loss + contrast
        return total, {"loss": total, "w_loss": w_loss, "s_loss": s_loss,
                       "contrastive": contrast}

    return loss_fn


def make_damsm_step(cfg: Config, clip: ClipWithRegionHead,
                    opt: DamsmOptimizer,
                    dtype: torch.dtype = torch.float32,
                    mesh: Optional[DataMesh] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The DAMSM step, as ``t2igan.train.steps.make_damsm_step``: the
    returned ``step(batch)`` takes the gradients of
    :func:`make_damsm_loss`'s total with respect to every parameter of
    ``clip`` and applies ``opt`` (global-norm clip, two-group Adam), both
    in place.  It returns the loss metrics and ``grad_norm`` (the global
    norm before the clip) as detached 0-dim tensors.

    Under a ``mesh`` the loss is :func:`make_damsm_loss`'s over the global
    batch and the gradients are averaged over ranks before the update, so
    the global norm, the clip and Adam see the global gradient and every
    rank's CLIP and Adam state stay equal."""
    mesh = mesh or DataMesh.single(clip.logit_scale.device)
    loss_fn = make_damsm_loss(cfg, clip, dtype, mesh)
    params = list(clip.parameters())

    def step(batch) -> Dict[str, torch.Tensor]:
        total, metrics = loss_fn(batch)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = g
        mesh.all_reduce_grads_(params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = opt.step()
        return metrics

    return step


def make_gan_step(cfg: Config, clip: ClipWithRegionHead,
                  dtype: torch.dtype = torch.float32,
                  mesh: Optional[DataMesh] = None) -> Callable[..., Dict]:
    """The adversarial step, as ``t2igan.train.steps.make_gan_step``.

    The returned ``step(state, batch, z=None, eps1=None, eps2=None,
    generator=None)`` updates ``state`` in place and returns the metrics
    as 0-dim tensors.  ``batch`` holds ``images`` (one [B, s, s, 3] array
    or tensor per pyramid size), ``ids``/``mask`` and ``ids_2``/``mask_2``
    (the two caption views, mask 1 at real tokens) and ``class_ids``.
    ``z`` [B, Z_DIM] and the conditioning noise ``eps1``/``eps2``
    [B, CONDITION_DIM] are drawn from the ``torch.Generator`` ``generator``
    when not given.  One step:

    1. both caption views through the text tower in one [2B] apply, with
       no gradient;
    2. one G forward per view in train mode (shared z; batch statistics
       update for view 1, then view 2);
    3. per scale, the discriminator update on the detached fakes: one
       trunk apply over [real, fake1, fake2], the only one that stores the
       spectral-norm vectors, the heads (wrong pair by a roll of the
       sentences), then the D optimizer;
    4. G's loss against the updated discriminators: 2 * the adversarial
       BCE over one [2B] trunk apply per scale, the DAMSM word and
       sentence terms of both views through one [2B] apply of the frozen
       CLIP vision tower on the 256->224 nearest-resized finest fakes, KL
       for both views and 0.2 * NT-Xent of the two image codes; gradients
       reach G only;
    5. the G optimizer, then the EMA.

    ``dtype=torch.bfloat16`` runs the forwards under ``torch.autocast``
    (parameters, optimizer state and EMA stay f32); losses are f32.

    Under a ``mesh`` with a group (:mod:`t2igan_torch.parallel.mesh`) the
    step is the JAX step on the global batch, of which ``batch`` holds
    this rank's rows: ``z``, ``eps1`` and ``eps2`` are drawn (or given)
    for the global batch and each rank takes its rows; G's BatchNorms
    normalise over the global batch; D's wrong pair rolls the gathered
    sentences; each D's gradients are averaged over ranks before its
    optimizer; the adversarial and KL terms are local means, the DAMSM
    word and sentence terms and NT-Xent are computed whole over gathered
    rows, and G's gradients are averaged over ranks.  The metrics are
    the global values, and every rank's parameters, spectral vectors,
    running statistics, optimizer states and EMA stay equal.

    ``GAN.B_DCGAN`` raises ``NotImplementedError``: the JAX package's step
    cannot train ``GDCGan`` either (it pairs the 64 px real image with the
    fakes of the one finest-size discriminator and calls that
    discriminator's unconditional head, which it is built without).
    """
    if cfg.GAN.B_DCGAN:
        raise NotImplementedError(
            "training with GAN.B_DCGAN: the JAX package's make_gan_step "
            "cannot train GDCGan either (t2igan/train/steps.py feeds the "
            "64 px real images to the single 256 px discriminator and calls "
            "its missing unconditional head); ROADMAP.md F19")
    g1 = cfg.TRAIN.SMOOTH.GAMMA1
    g2 = cfg.TRAIN.SMOOTH.GAMMA2
    g3 = cfg.TRAIN.SMOOTH.GAMMA3
    lam = cfg.TRAIN.SMOOTH.LAMBDA
    clip_size = clip.cfg.image_size
    mesh = mesh or DataMesh.single(clip.logit_scale.device)
    rows, live = mesh.gather_rows, mesh.gather_rows_live

    def step(state: GanTrainState, batch, z: Optional[torch.Tensor] = None,
             eps1: Optional[torch.Tensor] = None,
             eps2: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Dict:
        gen = state.gen
        device = next(gen.parameters()).device

        def amp():
            return torch.autocast(device.type, dtype=torch.bfloat16,
                                  enabled=dtype == torch.bfloat16)

        def put(x):
            return torch.as_tensor(x, device=device)

        ids, mask = put(batch["ids"]), put(batch["mask"])
        ids2, mask2 = put(batch["ids_2"]), put(batch["mask_2"])
        cls = put(batch["class_ids"])
        images = [put(x).float() for x in batch["images"]]
        b = ids.shape[0]
        noise = []
        for t, dim in ((z, cfg.GAN.Z_DIM), (eps1, cfg.GAN.CONDITION_DIM),
                       (eps2, cfg.GAN.CONDITION_DIM)):
            if t is None:
                if generator is None:
                    raise ValueError("pass z, eps1 and eps2, or a "
                                     "torch.Generator to draw them from")
                t = torch.randn((b * mesh.world, dim), generator=generator,
                                device=generator.device)
            noise.append(mesh.local_rows(put(t).float()))
        z, eps1, eps2 = noise

        with torch.no_grad(), amp():
            words, sent = clip.encode_text_verbose(torch.cat([ids, ids2]),
                                                   torch.cat([mask, mask2]))
        words1, words2 = words.chunk(2)
        sent1, sent2 = sent.chunk(2)
        with amp(), global_batch_stats(mesh):
            f1, _, mu1, lv1 = gen(z, sent1, words1, mask == 0, eps1,
                                  return_attn=False, train=True)
            f2, _, mu2, lv2 = gen(z, sent2, words2, mask2 == 0, eps2,
                                  return_attn=False, train=True)
        # The wrong pair of row i is row i + 1 of the global batch.
        wrong1 = mesh.local_rows(wrong_pair(rows(sent1)))
        wrong2 = mesh.local_rows(wrong_pair(rows(sent2)))

        metrics: Dict[str, torch.Tensor] = {}
        for i, (d, opt) in enumerate(zip(state.ds, state.d_opts)):
            with amp():
                x = torch.cat([images[i], f1[i].detach().float(),
                               f2[i].detach().float()])
                h_r, h_f1, h_f2 = d.features(x, update_spectral=True).chunk(3)
                uncond = d.uncond_head is not None
                logits = [d.cond(h_r, sent1), d.cond(h_f1, sent1),
                          d.cond(h_r, wrong1),
                          d.uncond(h_r) if uncond else None,
                          d.uncond(h_f1) if uncond else None,
                          d.cond(h_r, sent2), d.cond(h_f2, sent2),
                          d.cond(h_r, wrong2),
                          d.uncond(h_r) if uncond else None,
                          d.uncond(h_f2) if uncond else None]
            loss1, aux = discriminator_loss(*logits[:5])
            loss2, _ = discriminator_loss(*logits[5:])
            d_loss = loss1 + loss2
            params = [p for p in d.parameters() if p.requires_grad]
            for p, g in zip(params, torch.autograd.grad(d_loss, params)):
                p.grad = g
            mesh.all_reduce_grads_(params)
            opt.step()
            metrics[f"d_loss{i}"] = d_loss.detach()
            metrics[f"real_acc{i}"] = aux["real_acc"].detach()
            metrics[f"fake_acc{i}"] = aux["fake_acc"].detach()

        sent12 = torch.cat([sent1, sent2])
        adv = 0.0
        for i, d in enumerate(state.ds):
            with amp():
                h = d.features(torch.cat([f1[i], f2[i]]))
                cond = d.cond(h, sent12)
                uncond = d.uncond(h) if d.uncond_head is not None else None
            adv = adv + 2.0 * generator_adv_loss(cond, uncond)
        with amp():
            resized = resize_nearest(torch.cat([f1[-1], f2[-1]]), clip_size)
            subr12, img12 = clip.encode_image_verbose(resized)
        regions1, regions2 = subr12[:, 1:].float().chunk(2)
        cnn1, cnn2 = img12.float().chunk(2)
        regions1, regions2 = live(regions1), live(regions2)
        cnn1, cnn2 = live(cnn1), live(cnn2)
        words1, words2 = rows(words1), rows(words2)
        sent1, sent2 = rows(sent1), rows(sent2)
        mask, mask2, cls = rows(mask), rows(mask2), rows(cls)

        def damsm_terms(regions, img_code, words, mask, sent):
            wl0, wl1 = words_loss(regions, words, cls, mask > 0, g1, g2, g3)
            sl0, sl1 = sent_loss(img_code, sent, cls, g3)
            return (wl0 + wl1) * lam, (sl0 + sl1) * lam

        w_a, s_a = damsm_terms(regions1, cnn1, words1, mask, sent1)
        w_b, s_b = damsm_terms(regions2, cnn2, words2, mask2, sent2)
        kl = kl_loss(mu1, lv1) + kl_loss(mu2, lv2)
        contrast = 0.2 * nt_xent_loss(l2_normalize(cnn1),
                                      l2_normalize(cnn2), 0.5)
        total = adv + w_a + w_b + s_a + s_b + kl + contrast

        params = [p for p in gen.parameters() if p.requires_grad]
        for p, g in zip(params, torch.autograd.grad(total, params)):
            p.grad = g
        mesh.all_reduce_grads_(params)
        state.g_opt.step()
        ema_update(state.gen_ema, gen, EMA_DECAY)
        state.step += 1

        metrics["g_loss"] = total.detach()
        for name, val in (("g_adv", adv), ("w_loss", w_a + w_b),
                          ("s_loss", s_a + s_b), ("kl_loss", kl),
                          ("contrastive", contrast)):
            metrics[name] = val.detach()
        return dict(zip(metrics, mesh.mean_over_ranks(
            list(metrics.values()))))

    return step


def make_sampler(cfg: Config, clip: ClipWithRegionHead,
                 gen: Union[GNet, GDCGan], return_attn: bool = False
                 ) -> Callable:
    """Text -> images: the CLIP text tower, then the generator in eval
    mode.

    The returned ``sample(ids, mask, z, eps)`` takes token ids and the
    attention mask [B, L] (1 = real token), ``z`` [B, Z_DIM] and the
    conditioning noise ``eps`` [B, CONDITION_DIM], as arrays or tensors; it
    moves them to the generator's device and returns the images
    [B, s, s, 3] in [-1, 1], one per pyramid size (one, the finest, for a
    ``GDCGan``), computed under ``torch.inference_mode()``.  The memory
    read runs through the K1 kernel on a card (the plain version on the
    CPU).  With ``return_attn`` it returns ``(images, att_maps)``, the
    attention maps [B, H, W, L] (f32) of each refinement stage, and the
    read runs as plain einsums, as the JAX sampler's does.  ``cfg`` is
    taken for the JAX sampler's signature; the modules carry their widths.
    """
    del cfg
    device = next(gen.parameters()).device

    def sample(ids, mask, z, eps):
        with torch.inference_mode():
            ids = torch.as_tensor(ids, device=device)
            mask = torch.as_tensor(mask, device=device)
            words, sent = clip.encode_text_verbose(ids, mask)
            fakes, atts, _, _ = gen(torch.as_tensor(z, device=device), sent,
                                    words, mask == 0,
                                    torch.as_tensor(eps, device=device),
                                    return_attn=return_attn)
        return (fakes, atts) if return_attn else fakes

    return sample
