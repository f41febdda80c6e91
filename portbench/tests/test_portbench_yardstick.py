"""Bounds and FLOP counts against numbers worked by hand."""

import pytest

from portbench import flops, harness, rooflines

MAMBA = harness.read_json(harness.HERE / "configs" / "mamba2-1.3b.json")["model"]


def test_ssd_bound_at_mamba2_4x1024():
    # x 33.55 MB + dt 1.05 MB + A + B, C 2.10 MB + y 33.55 MB + state 8.39 MB = 78.64 MB
    nbytes = rooflines.ssd_bytes(4, 1024, 64, 64, 128, "bfloat16")
    assert nbytes == 2 * 4 * 1024 * 64 * 64 * 2 + 4 * 4 * 1024 * 64 + 4 * 64 \
        + 2 * 2 * 4 * 1024 * 128 + 4 * 4 * 64 * 128 * 64
    bound_ms = 1e3 * rooflines.ssd_bound_s(4, 1024, 64, 64, 128, 256, "bfloat16")
    assert bound_ms == pytest.approx(0.0235, abs=5e-5)
    # bound by bytes: the products (17.45 GFLOP) take 17.6 us at 989 TFLOP/s
    assert rooflines.ssd_flops(4, 1024, 64, 64, 128, 256) == pytest.approx(17.45e9, rel=1e-3)


def test_conv1d_bound_at_mamba2_4x1024():
    bound_ms = 1e3 * rooflines.conv1d_bound_s(4, 1024, 4352, 4, "bfloat16")
    assert bound_ms == pytest.approx(0.0213, abs=5e-5)


def test_ssd_backward_bound_reads_and_writes_each_tensor_once():
    fwd_in = rooflines.ssd_input_bytes(4, 2048, 64, 64, 128, "bfloat16")
    dy = 4 * 2048 * 64 * 64 * 2
    by_bytes = (2 * fwd_in + dy) / rooflines.HBM_BYTES_PER_S            # 63.9 us
    by_ops = 2 * rooflines.ssd_flops(4, 2048, 64, 64, 128, 256) / 989e12   # 70.6 us
    assert by_ops > by_bytes
    assert rooflines.ssd_bwd_bound_s(4, 2048, 64, 64, 128, 256, "bfloat16") == by_ops


def test_model_parameter_counts():
    # Mamba-2: 48 x (2048 x 8512 + 4096 x 2048) = 1.2391 B matmul parameters
    assert flops.body_params(MAMBA) == 48 * (2048 * 8512 + 4096 * 2048)
    assert flops.unembed_params(MAMBA) == 2048 * 50277


def test_prefill_flops_per_token_of_mamba2():
    per_token = flops.prefill_flops(MAMBA, 1, 4096) / 4096
    # 2 x 1.239 B + the SSD's 4.26 MFLOP a token a layer x 48 + the last row's unembedding
    assert per_token == pytest.approx(2 * 1.2391e9 + 48 * 4.26e6 + 2 * 2048 * 50277 / 4096,
                                      rel=1e-3)


def test_train_flops_is_three_forwards_with_the_loss():
    f = flops.train_flops(MAMBA, 4, 2048)
    fwd_all_rows = 2 * 4 * 2048 * (flops.body_params(MAMBA) + flops.unembed_params(MAMBA))
    ssd = 48 * rooflines.ssd_flops(4, 2048, 64, 64, 128, 256)
    assert f == pytest.approx(3 * (fwd_all_rows + ssd))
