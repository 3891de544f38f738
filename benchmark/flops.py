"""Model FLOPs of one call, counted from the configuration's shapes.

Counted: convolutions, linear layers and the attention products (CLIP's
logits and mixing, the memory read's logits and read-out), at 2 FLOPs a
multiply-add.  Not counted: normalisation, activations, gates, losses,
the optimizer.  A backward pass counts as twice its forward, and nothing
is recomputed.  A 2x nearest upsample followed by a 3x3 convolution is
counted as its four 2x2 phase convolutions at the input's size (16 taps a
pixel), the least work that computes it and the count of K3's bound
(:mod:`benchmark.yardstick`), so no implementation of it reads over 100%.
"""

from __future__ import annotations

from typing import List


def encoder_layer(tokens: int, d: int, mlp: int) -> float:
    """One pre-norm transformer layer on one sequence."""
    dense = 2 * tokens * (3 * d * d + d * d + 2 * d * mlp)
    return dense + 2 * 2 * tokens * tokens * d


def text_tower(clip: dict, rows: int) -> float:
    """CLIP's text tower at all ``max_positions`` and its projection."""
    t = clip["text"]
    l = clip["max_positions"]
    per = t["num_layers"] * encoder_layer(l, t["hidden_size"], t["mlp_dim"])
    return rows * (per + 2 * t["hidden_size"] * clip["projection_dim"])


def vision_tower(clip: dict, rows: int) -> float:
    """CLIP's vision tower, the region head and the image projection."""
    v = clip["vision"]
    p = clip["patch_size"]
    patches = (clip["image_size"] // p) ** 2
    tokens = patches + 1
    d = v["hidden_size"]
    per = (2 * patches * p * p * 3 * d
           + v["num_layers"] * encoder_layer(tokens, d, v["mlp_dim"])
           + 2 * tokens * d * clip["region_dim"]
           + 2 * d * clip["projection_dim"])
    return rows * per


def _conv(cin: int, cout: int, taps: int, pixels: int) -> float:
    return 2 * cin * cout * taps * pixels


def _upblock(cin: int, cout2: int, in_pixels: int) -> float:
    """Upsample 2x then conv3x3 -> cout2, as four 2x2 phase kernels."""
    return _conv(cin, cout2, 16, in_pixels)


def generator(w: dict, rows: int) -> float:
    """The cascaded generator, eval or train mode alike."""
    gf, nef, cond, z = (w["GF_DIM"], w["EMBEDDING_DIM"], w["CONDITION_DIM"],
                        w["Z_DIM"])
    words = w["WORDS_NUM"]
    ngf = gf * 16
    f = 2 * nef * 4 * cond                       # CA net
    f += 2 * (cond + z) * ngf * 16 * 2           # init fc
    side = 4
    for i in range(4):
        cin = ngf // 2 ** i
        f += _upblock(cin, 2 * (ngf // 2 ** (i + 1)), side * side)
        side *= 2
    c = 2 * gf
    for _ in range(w["BRANCH_NUM"] - 1):
        n = side * side
        f += 2 * (words * nef + gf)              # A, B
        f += 2 * (words * nef * c + gf * c)      # M_w, M_r
        f += 2 * 2 * words * c * gf              # key, value
        f += 2 * 2 * n * words * gf              # memory read
        f += _conv(c, 1, 1, n)                   # response gate
        f += w["R_NUM"] * (_conv(c, 2 * c, 9, n) + _conv(c, c, 9, n))
        f += _upblock(c, c, n)
        side *= 2
    for i in range(w["BRANCH_NUM"]):
        s = w["BASE_SIZE"] * 2 ** i
        f += _conv(gf, 3, 9, s * s)              # RGB heads
    return rows * f


def d_trunk(w: dict, size: int, rows: int) -> float:
    ndf = w["DF_DIM"]
    chans = [3, ndf, 2 * ndf, 4 * ndf, 8 * ndf]
    f, side = 0.0, size
    for a, b in zip(chans, chans[1:]):
        side //= 2
        f += _conv(a, b, 16, side * side)
    if size >= 128:
        f += _conv(8 * ndf, 16 * ndf, 16, 4 * 4)
        if size == 128:
            f += _conv(16 * ndf, 8 * ndf, 9, 4 * 4)
    if size >= 256:
        f += _conv(16 * ndf, 32 * ndf, 16, 4 * 4)
        f += _conv(32 * ndf, 16 * ndf, 9, 4 * 4) + _conv(16 * ndf, 8 * ndf,
                                                         9, 4 * 4)
    return rows * f


def d_head(w: dict, rows: int, cond: bool) -> float:
    ndf = w["DF_DIM"]
    f = _conv(8 * ndf, 1, 16, 1)
    if cond:
        f += _conv(8 * ndf + w["EMBEDDING_DIM"], 8 * ndf, 9, 16)
    return rows * f


def pyramid(w: dict) -> List[int]:
    return [w["BASE_SIZE"] * 2 ** i for i in range(w["BRANCH_NUM"])]


def train_step(w: dict, clip: dict, b: int) -> float:
    """One adversarial step at batch ``b``: the text tower on both views
    without gradient; G on both views, its backward through the
    discriminators and CLIP's vision tower; each discriminator's update
    on [real, fake1, fake2] with its 6 conditional and 4 unconditional
    head calls."""
    f = text_tower(clip, 2 * b) + 3 * generator(w, 2 * b)
    for s in pyramid(w):
        f += 3 * (d_trunk(w, s, 3 * b) + d_head(w, 6 * b, True)
                  + d_head(w, 4 * b, False))
        f += 3 * (d_trunk(w, s, 2 * b) + d_head(w, 2 * b, True)
                  + d_head(w, 2 * b, False))
    return f + 3 * vision_tower(clip, 2 * b)


def sample_call(w: dict, clip: dict, b: int) -> float:
    """The sampler: the text tower and G in eval mode."""
    return text_tower(clip, b) + generator(w, b)


def sweep_call(w: dict, clip: dict, b: int, mis: int) -> float:
    """One R-precision batch: the sampler, then the rank fn's image tower
    and the text tower on the true and the ``mis`` other captions."""
    return (sample_call(w, clip, b) + vision_tower(clip, b)
            + text_tower(clip, b * (1 + mis)))
