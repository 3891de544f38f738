"""The yardstick's arithmetic against hand counts: K3's work, bytes and
least time, the model FLOP counter, the peaks."""

import json
import math
from pathlib import Path

import pytest

from benchmark import flops, yardstick

ROOT = Path(__file__).resolve().parents[1]
CUB = json.loads((ROOT / "configs" / "cub_dmgan.json").read_text())
COCO = json.loads((ROOT / "configs" / "coco_dmgan.json").read_text())
STAGES = [((64, 64), False), ((128, 128), True)]


@pytest.mark.parametrize("dtype, r, want", [
    ("bf16", 2, 6.109), ("f32", 2, 36.618), ("f32", 3, 50.674),
    ("bf16", 3, 8.454)])
def test_k3_bound_reproduces_the_kernel_table(dtype, r, want):
    """PERF.md's K3 bounds at b128, C = 128, both stages summed."""
    got = yardstick.k3_bound_ms(128, STAGES, 128, r, dtype)
    assert round(got, 3) == want


def test_k3_stage_work_by_hand():
    """One ResBlock (C -> 2C and C -> C, 9 taps) and the upsample as 16
    phase taps on a 2x2 map of 16 channels, batch 1, f32, no head."""
    c, n = 16, 4
    flops_, nbytes = yardstick.k3_stage_work(1, (2, 2), c, 1, False, 4)
    assert flops_ == 2 * n * (9 * (2 * c * c + c * c) + 16 * c * c)
    weights = 9 * 3 * c * c + 9 * c * c
    assert nbytes == 4 * (n * c + weights + 4 * n * c // 2) + 4 * (6 * c
                                                                 + 2 * c)


def test_k3_bound_takes_the_larger_side():
    f, b = 1e12, 1e9
    assert yardstick.k3_stage_bound_ms(f, b, "bf16") == pytest.approx(
        f / 989e12 * 1e3)
    assert yardstick.k3_stage_bound_ms(1e6, 1e12, "bf16") == pytest.approx(
        1e12 / 3.35e12 * 1e3)
    assert yardstick.k3_stage_bound_ms(f, b, "f32") == pytest.approx(
        3 * f / 495e12 * 1e3)


def test_peaks():
    assert yardstick.MFU_PEAK == {"bf16": 989e12, "f32": 495e12}
    bound, t_bytes, t_ops, floor = yardstick.f32_bound(3.35e9, 1e12)
    assert t_bytes == pytest.approx(1.0)
    assert t_ops == pytest.approx(3e12 / 495e12 * 1e3)
    assert bound == max(t_bytes, t_ops)
    assert floor == pytest.approx(1e12 / 67e12 * 1e3)


def test_encoder_layer_by_hand():
    """qkv, out, fc1, fc2 and the two attention products."""
    l, d, m = 3, 4, 8
    assert flops.encoder_layer(l, d, m) == 2 * l * (4 * d * d + 2 * d * m) \
        + 4 * l * l * d


def test_text_tower_is_77_mflop_a_token():
    """ViT-B/32's text tower: ~77 MFLOP a token at 77 tokens (issue's
    reckoning of the sweep: 1000 captions -> ~5.9 TFLOP)."""
    per_token = flops.text_tower(CUB["clip"], 1) / 77
    assert 76e6 < per_token < 78e6
    assert 5.8e12 < flops.text_tower(CUB["clip"], 1000) < 6.0e12


def test_vision_tower_by_hand():
    clip = {"patch_size": 32, "image_size": 64, "region_dim": 5,
            "projection_dim": 6,
            "vision": {"hidden_size": 4, "num_layers": 1, "mlp_dim": 8}}
    tokens = 5
    want = (2 * 4 * 32 * 32 * 3 * 4 + flops.encoder_layer(tokens, 4, 8)
            + 2 * tokens * 4 * 5 + 2 * 4 * 6)
    assert flops.vision_tower(clip, 2) == 2 * want


def test_generator_counts_k3_work_in_its_tails():
    """The generator's two stage tails are K3's counted work (ResBlocks
    and the phase upsample at 64^2 and 128^2, the 256 px head)."""
    w = CUB["widths"]
    tails = sum(yardstick.k3_stage_work(128, hw, 128, w["R_NUM"], rgb, 2)[0]
                for hw, rgb in STAGES)
    g = flops.generator(w, 128)
    assert tails < g < tails * 1.12
    # R = 3 adds one ResBlock a stage: 2 * 9 * 3 C^2 a pixel.
    extra = flops.generator(COCO["widths"], 1) - flops.generator(w, 1)
    assert extra == sum(2 * 9 * 3 * 128 * 128 * s * s for s in (64, 128))


def test_d_trunk_by_hand():
    w = {"DF_DIM": 1}
    # 64 px: 3->1 at 32^2, 1->2 at 16^2, 2->4 at 8^2, 4->8 at 4^2, 16 taps
    want = 2 * 16 * (3 * 1 * 32 ** 2 + 1 * 2 * 16 ** 2 + 2 * 4 * 8 ** 2
                     + 4 * 8 * 4 ** 2)
    assert flops.d_trunk(w, 64, 1) == want


def test_train_step_is_three_forwards_of_what_trains_through():
    w, clip = CUB["widths"], CUB["clip"]
    b = 16
    step = flops.train_step(w, clip, b)
    assert step > 3 * flops.generator(w, 2 * b) + 3 * flops.vision_tower(
        clip, 2 * b)
    assert math.isclose(step / 1e12, 6.3169, rel_tol=1e-3)


def test_sweep_call_counts_1_plus_99_captions():
    w, clip = CUB["widths"], CUB["clip"]
    assert flops.sweep_call(w, clip, 10, 99) == (
        flops.sample_call(w, clip, 10) + flops.vision_tower(clip, 10)
        + flops.text_tower(clip, 1000))


def test_tf32_operands_keep_ten_mantissa_bits_to_nearest():
    """The TF32 control's rounding: the low 13 bits cleared, to nearest
    with ties away from zero, within half a unit of TF32's last place."""
    import torch

    from benchmark.reference.nets import Numerics

    x = torch.randn(10000, dtype=torch.float32) * 1e3
    r = Numerics("tf32").q(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - x) / x).abs().max()) <= 2.0 ** -11
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -12])
    assert Numerics("tf32").q(one).tolist() == [
        1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
