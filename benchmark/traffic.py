"""The one generator of the benchmark's inputs, read from a traffic file.

A traffic file (``traffic/<name>.json``) holds:

* ``batch``: rows a call; ``batches``: distinct batches made at set-up and
  cycled through by the window;
* ``caption_tokens`` [lo, hi]: words a caption, uniform, each row
  ``<sos> w_1 .. w_k <eos>`` padded with ``<eos>`` to the configuration's
  ``WORDS_NUM`` (mask 1 on the k + 2 real tokens), word ids uniform below
  ``<sos>``;
* ``views``: caption views a row (2 for training);
* ``classes``: class ids uniform over this many classes (0: none);
* ``images``: true to make each pyramid size's real images in [-1, 1];
* ``noise``: true to make ``z`` [B, Z_DIM] and ``eps`` [B, CONDITION_DIM];
* ``mis_captions`` and ``bank``: the R-precision draw, 1 + mis captions a
  query from a bank of ``bank`` captions over ``classes`` classes, drawn
  by the window on the host (:class:`MisCaptions`);
* ``assumed``: for each value that no published config gives, where it
  comes from (read by no code).

Every seed gets the same sizes and counts; only the values move.  The
batches are made on the device, in a few calls.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SOS, EOS = 49406, 49407


def derive(seed: int, stream: int) -> int:
    """Independent streams of one run's seed: 0 weights, 1 traffic, 2 the
    train step's noise, 3 the draws of the mis-captions, 4 which calls
    the check keeps."""
    return (int(seed) * 8 + stream) % (2 ** 63)


def captions(g: torch.Generator, rows: int, lo: int, hi: int, words: int,
             device) -> Dict[str, torch.Tensor]:
    """``ids``, ``mask`` [rows, words] int32."""
    n = torch.randint(lo, hi + 1, (rows, 1), generator=g, device=device)
    pos = torch.arange(words, device=device)[None]
    body = torch.randint(1, SOS, (rows, words), generator=g, device=device)
    ids = torch.where(pos == 0, SOS, torch.where(pos <= n, body, EOS))
    mask = (pos <= n + 1).to(torch.int32)
    return {"ids": ids.to(torch.int32), "mask": mask}


def batches(traffic: dict, seed: int, device, widths: dict
            ) -> List[Dict[str, object]]:
    """``traffic["batches"]`` batches of ``traffic["batch"]`` rows."""
    g = torch.Generator(device=device).manual_seed(derive(seed, 1))
    b = traffic["batch"]
    lo, hi = traffic["caption_tokens"]
    words = widths["WORDS_NUM"]
    out = []
    for _ in range(traffic["batches"]):
        batch: Dict[str, object] = dict(captions(g, b, lo, hi, words, device))
        if traffic.get("views", 1) == 2:
            second = captions(g, b, lo, hi, words, device)
            batch["ids_2"], batch["mask_2"] = second["ids"], second["mask"]
        if traffic.get("classes"):
            batch["class_ids"] = torch.randint(
                0, traffic["classes"], (b,), generator=g, device=device)
        if traffic.get("images"):
            sizes = [widths["BASE_SIZE"] * 2 ** i
                     for i in range(widths["BRANCH_NUM"])]
            batch["images"] = [
                torch.rand((b, s, s, 3), generator=g, device=device) * 2 - 1
                for s in sizes]
        if traffic.get("noise"):
            batch["z"] = torch.randn((b, widths["Z_DIM"]), generator=g,
                                     device=device)
            batch["eps"] = torch.randn((b, widths["CONDITION_DIM"]),
                                       generator=g, device=device)
        out.append(batch)
    return out


class MisCaptions:
    """The R-precision sweep's other-class captions: a bank of captions,
    made once, and per query ``mis_captions`` drawn with replacement from
    the captions of the other classes, as the program's
    ``MisCaptionBank`` draws them, on the host."""

    def __init__(self, traffic: dict, seed: int, widths: dict):
        g = torch.Generator().manual_seed(derive(seed, 1))
        lo, hi = traffic["caption_tokens"]
        bank = captions(g, traffic["bank"], lo, hi, widths["WORDS_NUM"],
                        "cpu")
        self.ids = bank["ids"].numpy()
        self.mask = bank["mask"].numpy()
        self.cls = np.arange(traffic["bank"]) % traffic["classes"]
        self.n = traffic["mis_captions"]
        self._comp = {c: np.flatnonzero(self.cls != c)
                      for c in range(traffic["classes"])}
        self._rng = np.random.default_rng(derive(seed, 3))

    def draw(self, class_ids: np.ndarray):
        """(ids, mask) [B, mis_captions, WORDS_NUM] int32."""
        rows = np.stack([comp[self._rng.integers(0, len(comp), self.n)]
                         for comp in (self._comp[int(c)] for c in class_ids)])
        return self.ids[rows], self.mask[rows]
