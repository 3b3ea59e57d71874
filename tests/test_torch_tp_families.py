"""Port parity of tensor-parallel serving beyond the dense and MoE GQA
decoders, at tp = 2 on spawned gloo ranks (one spawn, every case in it;
the cases' reference and tp = 1 halves in ``tests/_torch_tp_cases.py``):

* jamba-v0.1-52b-smoke on paged int8 pools: its Mamba mixers run whole
  on every rank, its attention layer over each rank's KV-head shard, its
  MoE E / 2 a rank; scatter on the gather route and eval_all on the
  kernel route;
* xlstm-350m-smoke on pages (states only: the mLSTM's and the sLSTM's
  fused column shards gathered, their 1-D leaves gathered whole);
* qwen2-vl-2b-smoke on paged int8 through the kernel route, and its
  embeds prefill with M-RoPE ids then embed decode steps under the plan
  (dense caches of each rank's KV heads);
* llama4-maverick-smoke with 3 experts: tp does not divide them, so the
  stacks stay whole on every rank and only the shared expert's
  row-parallel product is summed;
* qwen2-72b-smoke with the prefix cache and the quant tier on a float
  pool tight enough to requantize, deepen and restore: each fresh scale
  the max-abs over both ranks' heads, the tier's bytes the whole pool's.

Each case: step logits within 1e-4 of tp = 1's and of the reference's
single-device server (the recurrent archs: of its alone-served runs, C3),
tokens alike on both ranks, every host counter equal to tp = 1's, page
scales equal on both ranks, each cache leaf sharded or whole as
``paged_pool_specs`` says."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_tp_cases as tc  # noqa: E402
import _torch_tp_ranks as ranks  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-350m"
VLM, LLAMA, QWEN = "qwen2-vl-2b", "llama4-maverick-400b-a17b", "qwen2-72b"
PAGED8 = dict(batch_size=2, max_len=32, page_size=8, kv_bits=8)
SHORT = dict(lens=[5, 8, 3], max_new=4)
CASES = {
    "jamba-scatter-gather": dict(arch=JAMBA, over={"moe_mode": "scatter"},
                                 kw=dict(PAGED8, attn_impl="gather"),
                                 recurrent=True, **SHORT),
    "jamba-kernel": dict(arch=JAMBA, kw=dict(PAGED8, attn_impl="kernel"),
                         recurrent=True, **SHORT),
    "xlstm-paged": dict(arch=XLSTM, kw=PAGED8, recurrent=True, **SHORT),
    "qwen2-vl-kernel": dict(arch=VLM, kw=dict(PAGED8, attn_impl="kernel"),
                            lens=[6, 11, 4, 9], max_new=5),
    "llama4-e3": dict(arch=LLAMA, over={"num_experts": 3},
                      kw=dict(PAGED8, max_len=40),
                      lens=[6, 11, 4, 9], max_new=5),
    # a float pool of 7 usable pages: 4 requantizations, 4 deepens and 2
    # restores from the quant tier at tp = 1
    "qwen2-72b-tier": dict(arch=QWEN, kw=dict(
        batch_size=2, max_len=48, page_size=8, num_pages=8, kv_bits=0,
        prefix_cache="on", kv_adapt="on", adapt_pages=3),
        lens=[3, 4, 5, 3, 4, 5, 3, 4], max_new=4, prefixes=3),
}
EMBED_STEPS, EMBED_MAX_LEN = 3, 48


def _cases():
    out = {}
    for name, c in CASES.items():
        vocab = tc.model(c["arch"], c.get("over"))[1].vocab_size
        out[name] = dict(c, requests=tc.requests(
            vocab, lens=c["lens"], max_new=c["max_new"],
            prefixes=c.get("prefixes", 0)))
    return out


def embeds_inputs(seed=11):
    """Stub patch embeddings of a 2 x 4 x 4 grid and 8 text positions
    (2 rows), their M-RoPE ids, and one embedding per decode step."""
    cfg = tc.model(VLM)[1]
    ids = shapes.mrope_ids((2, 4, 4), 8).numpy()
    S = ids.shape[0]
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (2, S + EMBED_STEPS, cfg.d_model)
                     ).astype(np.float32)
    return emb, np.broadcast_to(ids, (2, S, 3)).copy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    prep = tc.prepare(cases, tmp_path_factory.mktemp("tp_families"))
    emb, mro = embeds_inputs()
    rc = prep["rank_cases"]["qwen2-vl-kernel"]
    embeds = {"cfg": rc["cfg"], "path": rc["path"], "embeds": emb,
              "mrope": mro, "steps": EMBED_STEPS, "max_len": EMBED_MAX_LEN}
    got = tmesh.spawn_ranks(ranks.serve_families, 2, 2, prep["rank_cases"],
                            embeds, device="cpu")
    return cases, prep, got


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_serves_the_family(runs, name):
    cases, prep, got = runs
    res = tc.check_case(name, prep, got, 2,
                        recurrent=cases[name].get("recurrent", False))
    cfg = prep["cfg"][name]
    w = got[0][name]["weights"]
    c = res["counters"]
    if name.startswith("jamba"):
        # the experts E / 2 a rank, Mamba's fused in_proj columns halved
        moe = next(n for n in w if n.endswith("mlp.w_gate")
                   and len(w[n]) == 3)
        assert w[moe][0] == cfg.num_experts // 2
        di = cfg.ssm_expand * cfg.d_model
        nh = di // cfg.ssm_head_dim
        assert w["layers.0.mixer.in_proj"] == (
            cfg.d_model, (2 * di + 2 * cfg.ssm_state_dim + nh) // 2)
        assert w["layers.0.mixer.A_log"] == (nh // 2,)
    if name == "xlstm-paged":
        assert w["layers.1.mixer.r"][-1] == 4 * cfg.d_model \
            // cfg.num_heads // 2
        assert all("k_pages" not in lay for lay in got[0][name]["layout"])
    if name == "llama4-e3":
        # tp does not divide 3 experts: the stacks stay whole, the shared
        # expert's w_down is row-parallel
        moe = [n for n in w if n.endswith("mlp.w_gate") and len(w[n]) == 3]
        assert moe and all(w[n][0] == 3 for n in moe)
        down = next(n for n in w if n.endswith("shared.w_down"))
        assert w[down][0] == cfg.moe_d_ff * cfg.num_shared_experts // 2
    if name == "qwen2-72b-tier":
        assert c["prefix.requants"] >= 1 and c["prefix.deepens"] >= 1
        assert c["prefix.tier_promotions"] >= 1


def test_tp2_vlm_embeds_prefill_and_decode(runs):
    """qwen2-vl-2b-smoke's embeds prefill (patch embeddings with M-RoPE
    ids) and embed decode steps under the plan: each step's logits within
    1e-4 of the port's unsharded steps and of the reference's, the dense
    caches holding each rank's KV heads."""
    _, prep, got = runs
    jcfg, tcfg, jparams, model = tc.model(VLM)
    emb, mro = embeds_inputs()
    S = mro.shape[1]
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=EMBED_MAX_LEN))
    jdec = jax.jit(jsteps.make_embed_decode_step(jcfg))
    last, jc = jpre(jparams, {"embeds": jnp.asarray(emb[:, :S]),
                              "mrope_positions": jnp.asarray(mro)})
    ref = [np.asarray(last)]
    tpre = tsteps.make_prefill_step(tcfg, max_len=EMBED_MAX_LEN)
    tdec = tsteps.make_embed_decode_step(tcfg)
    t_emb = torch.from_numpy(emb)
    tl, tcaches = tpre(model, None, embeds=t_emb[:, :S],
                       mrope_positions=torch.from_numpy(mro))
    one = [tl.numpy()]
    for i in range(EMBED_STEPS):
        _, lg, jc = jdec(jparams, jnp.asarray(emb[:, S + i:S + i + 1]),
                         S + i, jc)
        ref.append(np.asarray(lg))
        _, lg, tcaches = tdec(model, t_emb[:, S + i:S + i + 1], S + i,
                              tcaches)
        one.append(lg.numpy())
    two = got[0]["embeds"]
    assert len(two["logits"]) == len(one) == EMBED_STEPS + 1
    diff = {"tp1": max(float(np.abs(a - b).max())
                       for a, b in zip(two["logits"], one)),
            "ref": max(float(np.abs(a - b).max())
                       for a, b in zip(two["logits"], ref))}
    print(f"[tp2] embeds prefill + {EMBED_STEPS} embed decode steps: max "
          f"|diff| {diff}")
    assert max(diff.values()) < tc.TOL, diff
    for res in got:
        np.testing.assert_array_equal(res["embeds"]["logits"][-1],
                                      two["logits"][-1])
        assert res["embeds"]["caches"] == [
            (2, EMBED_MAX_LEN, tcfg.num_kv_heads // 2, tcfg.head_dim)
        ] * tcfg.num_layers
