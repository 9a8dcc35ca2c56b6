"""The work counters against hand counts (CPU, meta tensors)."""

import pytest
import torch

from portbench import work
from portbench.reference import caption as ref_caption
from portbench.reference import deid as ref_deid
from portbench.reference import tape
from portbench.work import flops


def test_conv3x3_bound_is_the_larger_of_bytes_and_operations():
    b, h, w, c, k = 8, 32, 32, 256, 512
    ops = 2 * 9 * b * h * w * c * k
    moved = 2 * (b * h * w * c + b * h * w * k + 9 * c * k)
    want = max(moved / work.HBM_BYTES_S, ops / work.BF16_FLOP_S)
    assert work.conv3x3_bound_s(b, h, w, c, k) == pytest.approx(want, rel=1e-12)
    # 8x32x32x256 -> 512 is bound by its operations; one image at 256^2
    # with 64 channels by its bytes.
    assert ops / work.BF16_FLOP_S > moved / work.HBM_BYTES_S
    small = work.conv3x3_bound_s(1, 256, 256, 16, 16)
    assert small == pytest.approx(2 * (256 * 256 * 32 + 9 * 256) / work.HBM_BYTES_S, rel=1e-12)


def test_instats_bound_is_its_bytes():
    b, h, w, c = 8, 128, 128, 64
    assert work.instats_bound_s(b, h, w, c) == pytest.approx((2 * b * h * w * c + 8 * b * c) / work.HBM_BYTES_S)


def _sd(**shapes):
    return {k: torch.empty(v, device="meta") for k, v in shapes.items()}


def test_flops_of_a_3x3_conv_and_its_resampled_forms():
    b, c, k, h = 2, 32, 48, 16
    sd = _sd(**{"c.weight": (k, c, 3, 3), "c.bias": (k,)})
    x = torch.empty((b, c, h, h), device="meta")
    total, t = flops.count(ref_deid._conv3x3, x, sd, "c")
    assert total == 2 * 9 * b * h * h * c * k
    assert t == [("conv3x3", (b, h, h, c, k))]
    # Nearest-up2x then 3x3: each of the (2h)^2 outputs sees a 2x2
    # neighbourhood of the input, 4 taps, not 9.
    total, t = flops.count(ref_deid._conv3x3_up, x, sd, "c")
    assert total == 2 * 4 * b * (2 * h) ** 2 * c * k and t == []
    # 3x3 then a 2x2 mean: each of the (h/2)^2 outputs a 4x4 window.
    total, _ = flops.count(ref_deid._conv3x3_pool, x, sd, "c")
    assert total == 2 * 16 * b * (h // 2) ** 2 * c * k


def test_resnet101_forward_flops_match_the_published_count():
    """torchvision lists ResNet-101 (v1.5) at 7.80 GMACs an image at
    224^2; the reference encoder is that trunk without its classifier
    (2048 x 1000 MACs)."""
    sd = {}
    cin, mid = 64, 64
    sd["conv1.weight"] = (64, 3, 7, 7)
    for s, blocks in enumerate((3, 4, 23, 3)):
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            sd[f"{p}.conv1.weight"] = (mid, cin, 1, 1)
            sd[f"{p}.conv2.weight"] = (mid, mid, 3, 3)
            sd[f"{p}.conv3.weight"] = (4 * mid, mid, 1, 1)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = (4 * mid, cin, 1, 1)
            cin = 4 * mid
        mid *= 2
    for name in list(sd):
        if name.endswith("weight"):
            bn = name.replace("conv", "bn").replace("downsample.0", "downsample.1")
            if name == "conv1.weight":
                bn = "bn1.weight"
            sd[bn] = (sd[name][0],)
            sd[bn.replace("weight", "bias")] = (sd[name][0],)
    meta = _sd(**sd)
    total, _ = flops.count(ref_caption.encoder_forward, meta, torch.empty((1, 224, 224, 3), device="meta"), 7)
    assert total / 2 == pytest.approx(7.80e9 - 2048 * 1000, rel=0.01)


def test_nothing_is_taped_outside_a_count():
    assert not tape.counting()
    tape.note("conv3x3", 1, 2, 3, 4, 5)
    with tape.recording() as t:
        tape.note("instats", 1, 2, 2, 8)
    assert t == [("instats", (1, 2, 2, 8))]


def test_kernel_bound_sums_the_taped_calls_of_one_kind():
    t = [("conv3x3", (1, 8, 8, 16, 16)), ("instats", (1, 8, 8, 16)), ("conv3x3", (2, 8, 8, 16, 32))]
    want = work.conv3x3_bound_s(1, 8, 8, 16, 16) + work.conv3x3_bound_s(2, 8, 8, 16, 32)
    assert work.kernel_bound_s(t, "conv3x3") == pytest.approx(want)
