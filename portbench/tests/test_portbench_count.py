"""`portbench/count/`'s FLOPs and bytes against counts worked by hand at
a tiny size: d 8, 2 heads of 4 over 1 K/V head, d_ff 16, vocabulary
32, 2 layers, 4 experts top-2."""
from portbench.count import dense, moe

C = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
     "intermediate_size": 16, "vocab_size": 32, "num_hidden_layers": 2,
     "num_local_experts": 4, "num_experts_per_tok": 2}


def test_prefill_flops_by_hand():
    # B 1, S 3: projections 2*3*8*(2*2*4 + 2*1*4) = 1152; causal
    # attention 4*1*2*4 * 6 pairs = 192; MLP 2*3*3*8*16 = 2304; two
    # layers, then the head at the last position 2*8*32 = 512
    assert dense.proj_flops(C, 3) == 1152
    assert dense.causal_attn_flops(C, 1, 3) == 192
    assert dense.mlp_flops(C, 3) == 2304
    assert dense.prefill_flops(C, 1, 3) == 2 * (1152 + 192 + 2304) + 512


def test_flash_call_by_hand():
    # Q and O 2 heads, K and V 1 head, 3 positions of 4 dims, bf16
    assert dense.flash_call(C, 1, 3) == (192, 2 * 3 * 4 * (2 * 2 + 2 * 1))


def test_decode_step_flops_by_hand():
    # B 2 against 5 valid positions, a layer: projections 768, attention
    # 4*2*2*4*5 = 320, router 2*2*8*4 = 128, dense MLP 1536, 2 experts a
    # token 3072; two layers and the head 2*2*8*32 = 1024
    layer = 768 + 320 + 128 + 1536 + 3072
    assert moe.decode_step_flops(C, 2, 5) == 2 * layer + 1024


def test_decode_step_bytes_by_hand():
    # elements a layer: norms 16, Q/K/V/O 192, K/V read 2*2*5*1*4 = 80,
    # new K/V 16, router 32, dense MLP 384, each distinct expert 384;
    # embedding rows 16, final norm 8, head 256; bf16, float32 logits
    base = 16 + 192 + 80 + 16 + 32 + 384
    elems = 16 + (base + 3 * 384) + (base + 1 * 384) + 8 + 256
    assert moe.decode_step_bytes(C, 2, 5, [3, 1]) == 2 * elems + 4 * 2 * 32


def test_bytes_count_chosen_experts_only():
    """Fewer distinct experts need fewer bytes: all E are never assumed."""
    few = moe.decode_step_bytes(C, 2, 5, [1, 1])
    every = moe.decode_step_bytes(C, 2, 5, [4, 4])
    assert every - few == 2 * 2 * 3 * 3 * 8 * 16
