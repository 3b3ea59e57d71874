"""Port parity of tensor-parallel serving where tp does not divide the KV
heads, at tp = 4 on spawned gloo ranks (one spawn, every case in it):
qwen2-72b-smoke and qwen2-vl-2b-smoke have 2 KV heads, so the reference
replicates their paged pools (``parallel/sharding.py``'s divisibility
fallback) while ``wk`` and ``wv`` are still cut into column shards of
half a head. Every rank gathers q, k and v whole, writes the whole pool
alike, attends over every head at the model's own group size and hands
the row-parallel ``wo`` its rows of the output.

* qwen2-72b-smoke with the prefix cache and per-page scales (a
  replicated pool computes its page absmax whole: no max over the
  ranks) on the gather route;
* qwen2-vl-2b-smoke on the kernel route (its plain version here: B1's
  arguments at the model's own group size; its tied head row-parallel,
  the table's D shards), and its embeds prefill with M-RoPE ids then
  embed decode steps under the plan, on dense caches of every KV head.

Each case as ``tests/test_torch_tp_families.py``'s: step logits within
1e-4 of tp = 1's and of the reference's single-device server, tokens
alike on every rank, every host counter equal to tp = 1's, page scales
equal on every rank, each pool whole as ``paged_pool_specs`` says."""
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

TP = 4
VLM, QWEN = "qwen2-vl-2b", "qwen2-72b"
CASES = {
    "qwen2-72b-page-gather": dict(arch=QWEN, kw=dict(
        batch_size=2, max_len=40, page_size=8, kv_bits=8, kv_scale="page",
        prefix_cache="on", attn_impl="gather"),
        lens=[3, 5, 4, 6], max_new=5, prefixes=2),
    "qwen2-vl-kernel": dict(arch=VLM, kw=dict(
        batch_size=2, max_len=32, page_size=8, kv_bits=8,
        attn_impl="kernel"), lens=[6, 11, 4, 9], max_new=5),
}
EMBED_STEPS, EMBED_MAX_LEN = 3, 32


def embeds_inputs(seed=12):
    """Stub patch embeddings of a 1 x 4 x 4 grid and 6 text positions
    (2 rows), their M-RoPE ids, and one embedding per decode step."""
    cfg = tc.model(VLM)[1]
    ids = shapes.mrope_ids((1, 4, 4), 6).numpy()
    S = ids.shape[0]
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (2, S + EMBED_STEPS, cfg.d_model)
                     ).astype(np.float32)
    return emb, np.broadcast_to(ids, (2, S, 3)).copy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {}
    for name, c in CASES.items():
        vocab = tc.model(c["arch"])[1].vocab_size
        cases[name] = dict(c, requests=tc.requests(
            vocab, lens=c["lens"], max_new=c["max_new"],
            prefixes=c.get("prefixes", 0)))
    prep = tc.prepare(cases, tmp_path_factory.mktemp("tp4"))
    emb, mro = embeds_inputs()
    rc = prep["rank_cases"]["qwen2-vl-kernel"]
    embeds = {"cfg": rc["cfg"], "path": rc["path"], "embeds": emb,
              "mrope": mro, "steps": EMBED_STEPS, "max_len": EMBED_MAX_LEN}
    got = tmesh.spawn_ranks(ranks.serve_families, TP, TP,
                            prep["rank_cases"], embeds, device="cpu")
    return prep, got


@pytest.mark.parametrize("name", list(CASES))
def test_tp4_serves_over_a_replicated_pool(runs, name):
    prep, got = runs
    tc.check_case(name, prep, got, TP, recurrent=False)
    cfg = prep["cfg"][name]
    w = got[0][name]["weights"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert KV % TP and (KV * hd) % TP == 0
    # wk cut inside a head; the pool whole on every rank
    assert w["layers.0.attn.wk"] == (cfg.d_model, KV * hd // TP)
    assert w["layers.0.attn.wq"] == (cfg.d_model, H * hd // TP)
    assert w["layers.0.attn.wo"] == (H * hd // TP, cfg.d_model)
    for lay in got[0][name]["layout"]:
        assert lay["k_pages"][0][2] == KV and lay["k_pages"][1] is None
    if name.startswith("qwen2-72b"):
        assert got[0][name]["counters"]["prefix.hits"] >= 1


def test_tp4_vlm_embeds_prefill_and_decode(runs):
    """qwen2-vl-2b-smoke's embeds prefill and embed decode steps under a
    plan whose model axis does not divide its 2 KV heads: each step's
    logits within 1e-4 of the port's unsharded steps and of the
    reference's, the dense caches holding every KV head."""
    _, got = runs
    jcfg, tcfg, jparams, model = tc.model(VLM)
    emb, mro = embeds_inputs()
    S = mro.shape[1]
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=EMBED_MAX_LEN))
    jdec = jax.jit(jsteps.make_embed_decode_step(jcfg))
    last, jc = jpre(jparams, {"embeds": jnp.asarray(emb[:, :S]),
                              "mrope_positions": jnp.asarray(mro)})
    ref = [np.asarray(last)]
    t_emb = torch.from_numpy(emb)
    tl, tcaches = tsteps.make_prefill_step(tcfg, max_len=EMBED_MAX_LEN)(
        model, None, embeds=t_emb[:, :S],
        mrope_positions=torch.from_numpy(mro))
    one = [tl.numpy()]
    tdec = tsteps.make_embed_decode_step(tcfg)
    for i in range(EMBED_STEPS):
        _, lg, jc = jdec(jparams, jnp.asarray(emb[:, S + i:S + i + 1]),
                         S + i, jc)
        ref.append(np.asarray(lg))
        _, lg, tcaches = tdec(model, t_emb[:, S + i:S + i + 1], S + i,
                              tcaches)
        one.append(lg.numpy())
    four = got[0]["embeds"]
    diff = {"tp1": max(float(np.abs(a - b).max())
                       for a, b in zip(four["logits"], one)),
            "ref": max(float(np.abs(a - b).max())
                       for a, b in zip(four["logits"], ref))}
    print(f"[tp4] embeds prefill + {EMBED_STEPS} embed decode steps: max "
          f"|diff| {diff}")
    assert max(diff.values()) < tc.TOL, diff
    for res in got:
        np.testing.assert_array_equal(res["embeds"]["logits"][-1],
                                      four["logits"][-1])
        assert res["embeds"]["caches"] == [
            (2, EMBED_MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim)
        ] * tcfg.num_layers
