"""The bound and operation arithmetic against hand counts at small shapes."""

import pytest

from portbench import counts


def test_tsm_conv_work_by_hand():
    flops, nbytes = counts.tsm_conv_work(t=2, h=4, w=8, c=16)
    assert flops == 2 * 9 * 16 * 16 * 2 * 4 * 8
    # x and out (2 * T*H*W*C), prev1 (H*W*C), left0 (H*W*C/8), weights, bias: bf16
    assert nbytes == 2 * (2 * 2 * 4 * 8 * 16 + 4 * 8 * 16 + 4 * 8 * 2 + 9 * 16 * 16 + 16)


def test_conv_stack_and_warp_work_by_hand():
    flops, nbytes = counts.conv_stack_work(n=1, h=2, w=3, layers=2)
    assert flops == 2 * 2 * 9 * 64 * 64 * 6
    assert nbytes == 2 * (6 * 64 * 2) + 2 * (9 * 64 * 64 * 2 + 64 * 8)
    flops, nbytes = counts.backward_warp_work(n=1, h=2, w=4, c=3)
    assert flops == 15 * 24 and nbytes == 2 * 24 * 2 + 8 * 2 * 2 + 1


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 1.0, counts.PEAK_F32_FLOPS) == pytest.approx(1.0)
    # the main path's K1 and K4 bounds as the program's tools print them (ms)
    assert counts.bound_s(*counts.tsm_conv_work(4, 360, 640, 64)) * 1e3 == pytest.approx(0.0804, abs=1e-4)
    assert counts.bound_s(*counts.conv_stack_work(4, 720, 1280)) * 1e3 == pytest.approx(0.2817, abs=1e-4)
    items = [{"work": "tsm_conv", "args": {"t": 4, "h": 360, "w": 640, "c": 64}, "count": 2}]
    assert counts.kernel_bound_s(items) == pytest.approx(2 * counts.bound_s(*counts.tsm_conv_work(4, 360, 640, 64)))


def _conv(cin, cout, h, w):
    return 2 * 9 * cin * cout * h * w


def test_frame_flops_by_hand_at_a_small_shape():
    h, w = 8, 16
    got = counts.frame_flops({"model": "egvsr", "lr_shape": [h, w], "frnet": {"nb": 10},
                              "weights": "weights/minted/egvsr-derived-x4.pth"})
    fnet = (_conv(6, 32, h, w) + _conv(32, 32, h, w) + _conv(32, 64, h // 2, w // 2) + _conv(64, 64, h // 2, w // 2)
            + _conv(64, 128, h // 4, w // 4) + _conv(128, 128, h // 4, w // 4) + _conv(128, 256, 1, 2)
            + _conv(256, 256, 1, 2) + _conv(256, 128, h // 4, w // 4) + _conv(128, 128, h // 4, w // 4)
            + _conv(128, 64, h // 2, w // 2) + _conv(64, 64, h // 2, w // 2) + _conv(64, 32, h, w)
            + _conv(32, 2, h, w))
    srnet = _conv(51, 64, h, w) + 2 * 10 * _conv(64, 64, h, w) + _conv(4, 3, 4 * h, 4 * w)
    assert got == fnet + srnet
    got = counts.frame_flops({"model": "realesrgan", "lr_shape": [h, w], "srvgg": {"num_conv": 32},
                              "weights": "weights/minted/srvgg-derived-x4.pth",
                              "denoise_weights": "weights/minted/bsvd-derived-32.pth"})
    srvgg = _conv(3, 64, h, w) + 32 * _conv(64, 64, h, w) + _conv(64, 48, h, w)

    def denblock(cin, cout):
        full = _conv(cin, 30, h, w) + _conv(30, 32, h, w) + _conv(32, 32, h, w) + _conv(32, cout, h, w)
        half = _conv(32, 64, h // 2, w // 2) + 4 * _conv(64, 64, h // 2, w // 2) + _conv(64, 128, h // 2, w // 2)
        quarter = _conv(64, 128, h // 4, w // 4) + 4 * _conv(128, 128, h // 4, w // 4) + _conv(128, 256, h // 4, w // 4)
        return full + half + quarter

    assert got == srvgg + denblock(4, 32) + denblock(32, 3)
