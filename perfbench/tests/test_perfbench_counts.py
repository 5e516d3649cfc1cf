"""FLOPs and bytes from published sizes, against values worked by hand
for a tiny configuration."""
from perfbench import counts

DENSE = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 10}
MOE = {"num_layers": 3, "d_model": 8, "num_heads": 2, "vocab_size": 10,
       "d_ff": 16,
       "mla": {"q_lora_rank": 4, "kv_lora_rank": 2, "qk_nope_head_dim": 3,
               "qk_rope_head_dim": 1, "v_head_dim": 2},
       "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 5,
               "num_shared_experts": 1, "d_ff_shared": 5,
               "first_dense_layers": 1}}


def test_dense_counts():
    # attention: q 8*2*4=64, k 32, v 32, o 64 -> 192; GLU 3*8*16 = 384
    assert counts.attention_params(DENSE) == 192
    assert counts.ffn_params(DENSE, 0, True) == 384
    assert counts.token_weight_flops(DENSE) == 2.0 * 2 * (192 + 384)
    assert counts.head_flops(DENSE) == 2.0 * 8 * 10
    # 4 * H * hd per position and layer
    assert counts.attention_flops_per_position(DENSE) == 4.0 * 2 * 4 * 2
    # prompt 3: 3 tokens, 6 causal pairs, one head
    assert counts.prefill_flops(DENSE, 3) == 3 * 2304 + 6 * 64 + 160
    assert counts.decode_token_flops(DENSE, 5) == 2304 + 160 + 5 * 64
    # kv: 2 * G * hd * 2 bytes * layers
    assert counts.kv_bytes_per_position(DENSE) == 2 * 1 * 4 * 2 * 2
    # weights (2 * (192 + 384) + lm_head 80) * 2 bytes, norms (2*2*8 + 8) * 4,
    # 3 embedding rows * 8 * 2, contexts 4 + 6 positions * 32
    want = (2 * 576 + 80) * 2 + 40 * 4 + 3 * 8 * 2 + 10 * 32
    assert counts.decode_step_bytes(DENSE, 3, [4, 6]) == want


def test_mla_moe_counts():
    # q: 8*4 + 4*2*(3+1) = 64; kv: 8*(2+1) + 2*2*(3+2) = 44; o: 2*2*8 = 32
    assert counts.attention_params(MOE) == 140
    assert counts.ffn_params(MOE, 0, True) == 3 * 8 * 16
    # routed top 2 of 4: 2 * 3*8*5 + shared 3*8*5 + router 8*4
    assert counts.ffn_params(MOE, 1, True) == 240 + 120 + 32
    assert counts.ffn_params(MOE, 2, False) == 4 * 120 + 120 + 32
    assert counts.token_weight_flops(MOE) == 2.0 * (3 * 140 + 384 + 2 * 392)
    # 2*H*(nope+rope) + 2*H*v = 16 + 8 a layer
    assert counts.attention_flops_per_position(MOE) == 24.0 * 3
    assert counts.kv_bytes_per_position(MOE) == (2 + 1) * 2 * 3
