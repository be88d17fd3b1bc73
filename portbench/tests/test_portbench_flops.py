"""The yardstick's FLOP and byte counts against values worked by hand."""

import pytest

from portbench import flops


def test_encoder_layer():
    # 2 b t (4 d^2 + 2 d f) + 4 b t^2 d at b 2, t 10, d 4, f 8
    assert flops.encoder_layer_flops(2, 10, 4, 8) == 5120 + 3200
    assert flops.encoder_layer_flops(1, 2, 4, 8) == 512 + 64


def test_hubert():
    a = {"conv_layers": [[2, 4, 2], [3, 2, 2]], "encoder_embed_dim": 4, "encoder_ffn_dim": 8,
         "encoder_layers": 1, "pos_conv_groups": 2, "pos_conv_kernel": 3}
    # conv0 4 frames: 2*4*2*1*4; conv1 2 frames: 2*2*3*2*2; proj 2*2*3*4;
    # pos_conv 2*2*4*2*3; one layer at t 2
    assert flops.conv_out_len(10, a["conv_layers"]) == [4, 2]
    assert flops.hubert_flops(a, 1, 10) == 64 + 48 + 48 + 96 + 576
    # the base model at 6.4 s: about 92 GFLOP an utterance
    base = {"conv_layers": [[512, 10, 5]] + [[512, 3, 2]] * 4 + [[512, 2, 2]] * 2,
            "encoder_embed_dim": 768, "encoder_ffn_dim": 3072, "encoder_layers": 12,
            "pos_conv_groups": 16, "pos_conv_kernel": 128}
    assert 88e9 < flops.hubert_flops(base, 1, 102400) < 96e9


BF16, F32, I32 = "c10::BFloat16", "float", "int"


@pytest.mark.parametrize("shapes,dtypes,valid,want_flops,want_bytes", [
    # x (2, 10, 4), w_in (4, 12), b_in, w_out, b_out, no LN, lens (2): half the keys valid
    ([[2, 10, 4], [4, 12], [12], [4, 4], [4], [], [], [2]],
     [BF16, BF16, F32, BF16, F32, "", "", I32], 0.5, 2560 + 1600, 360 + 160),
    # x (1, 4, 8) with its LayerNorm and no lengths: every key counts
    ([[1, 4, 8], [8, 24], [24], [8, 8], [8], [8], [8], []],
     [BF16, BF16, F32, BF16, F32, F32, F32, ""], 0.5, 2048 + 512, 768 + 64),
])
def test_mha_layer_block(shapes, dtypes, valid, want_flops, want_bytes):
    cost = flops.op_cost("mha_layer_block", shapes, dtypes, valid)
    assert cost == {"flops": want_flops, "bytes": want_bytes}


def test_ffn_and_attention():
    cost = flops.op_cost("ffn_block", [[2, 3, 4], [4, 16], [16], [16, 4], [4], [], []],
                         [BF16, BF16, F32, BF16, F32, "", ""], 1.0)
    assert cost == {"flops": 4 * 2 * 3 * 4 * 16, "bytes": 384 + 48}
    q = [1, 2, 8, 4]
    cost = flops.op_cost("attention_vmem", [q, q, q, [1]], [BF16, BF16, BF16, I32], 0.25)
    assert cost == {"flops": 4 * 2 * 8 * 2 * 4, "bytes": 3 * 128 + 4 + 128}
    assert flops.op_cost("fused_conv_chain", [[1, 2, 3]], [BF16], 1.0) is None


def test_bound():
    assert flops.bound_seconds({"flops": flops.PEAK_BF16_FLOPS, "bytes": 1.0}) == 1.0
    assert flops.bound_seconds({"flops": 1.0, "bytes": flops.PEAK_HBM_BYTES}) == 1.0
    assert flops.bound_seconds({"flops": flops.PEAK_F32_FLOPS, "bytes": 1.0}, f32=True) == 1.0


def test_train_step_counts_the_branch_three_times():
    sizes = {"audio": {"conv_layers": [[2, 4, 2], [3, 2, 2]], "encoder_embed_dim": 4,
                       "encoder_ffn_dim": 8, "encoder_layers": 1, "pos_conv_groups": 2,
                       "pos_conv_kernel": 3},
             "parallel_branch": {"n_layers": 1, "d_model": 4, "dim_feedforward": 8},
             "vision": {"output_dim": 5}}
    hub = flops.hubert_flops(sizes["audio"], 1, 10)
    branch = flops.encoder_layer_flops(1, 3, 4, 8) + 2 * 4 * 5
    assert flops.train_step_flops(sizes, 1, 10) == hub + 3 * (branch + 2 * 5)
    assert flops.encode_flops(sizes, 1, 10, 7) == hub + branch + 2 * 7 * 5
