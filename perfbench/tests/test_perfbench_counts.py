"""The count functions, pinned to chip_smoke.py phase 2's bounds at its
shapes, and the model's operations to the port's parameter count."""
import pytest

import counts


CTX = [2048, 0, 1, 17, 300, 1000, 1537, 777]    # phase 2's decode lanes


@pytest.mark.parametrize("h,kvh,want_ms", [(32, 8, 0.0070), (28, 4, 0.0035)])
def test_decode_bound_matches_phase2(h, kvh, want_ms):
    t, by = counts.bound_s(*counts.decode_attn(CTX, h, kvh, 128, 16))
    assert by == "bytes"
    assert round(t * 1e3, 4) == want_ms


@pytest.mark.parametrize("h,kvh,want_ms", [(32, 8, 0.0152), (28, 4, 0.0133)])
def test_prefill_bound_matches_phase2(h, kvh, want_ms):
    # the last 512-token chunk of a 2048-token prompt
    t, by = counts.bound_s(*counts.prefill_attn(1536, 512, h, kvh, 128))
    assert by == "operations"
    assert round(t * 1e3, 4) == want_ms


def test_causal_pairs_counts_each_query_once():
    assert counts.causal_pairs(0, 1) == 1
    assert counts.causal_pairs(3, 2) == 4 + 5
    assert counts.causal_pairs(1536, 512) == sum(1536 + i + 1
                                                 for i in range(512))


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-coder-33b"])
def test_model_flops_is_twice_the_port_params(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    per_layer = counts.layer_params(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.d_ff)
    embed_and_head = 2 * cfg.vocab_size * cfg.d_model
    assert cfg.n_layers * per_layer + embed_and_head == cfg.param_count()
    flops = counts.model_flops(cfg.n_layers, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                               cfg.vocab_size, tokens=1, attn_pairs=0,
                               head_rows=1)
    assert flops == 2 * (cfg.param_count() - cfg.vocab_size * cfg.d_model)
