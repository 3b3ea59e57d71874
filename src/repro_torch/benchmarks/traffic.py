"""Paper Fig. 4 byte-traffic accounting: single-image vs batch use cases,
weights vs intermediate data, per network, extended with the transformer
analogue (prefill weight-dominated, decode KV-data-dominated per LM arch).
Host arithmetic, equal to the reference's ``benchmarks/traffic.py``
accounting; its serving harness is still to port (ROADMAP queue A items 9
and 10).

    python -m repro_torch.benchmarks.traffic

Results: ``results/torch_traffic.json``.
"""
from __future__ import annotations

from ..configs.registry import ARCH_IDS, get_config
from ..models.cnn import SPECS, cnn_traffic_model
from ..quant.apply import transformer_traffic_model
from .common import cnn_nets, save_json


def cnn_traffic(batch=50):
    out = {}
    for net in cnn_nets():
        tm = cnn_traffic_model(SPECS[net])
        w_s, d_s = tm.accesses(batch, "single")
        w_b, d_b = tm.accesses(batch, "batch")
        out[net] = {
            "single": {"weights_M": w_s / 1e6, "data_M": d_s / 1e6},
            "batch": {"weights_M": w_b / 1e6, "data_M": d_b / 1e6},
            "weights_dominate_single": bool(w_s > d_s),
            "data_dominate_batch": bool(d_b > w_b),
        }
    return out


def lm_traffic():
    """Prefill vs decode access counts for the LM archs (per device-step,
    analytic)."""
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        tm_p = transformer_traffic_model(cfg, batch=32, seq_len=32768,
                                         mode="prefill")
        w_p, d_p = tm_p.accesses(1, "batch")
        if cfg.family != "encoder":
            tm_d = transformer_traffic_model(cfg, batch=128, seq_len=32768,
                                             mode="decode")
            w_d, d_d = tm_d.accesses(1, "batch")
        else:
            w_d = d_d = 0
        out[arch] = {
            "prefill": {"weights_G": w_p / 1e9, "data_G": d_p / 1e9},
            "decode_per_token": {"weights_G": w_d / 1e9, "data_G": d_d / 1e9},
            "kv_data_dominates_decode": bool(d_d > w_d) if w_d else None,
        }
    return out


def run_accounting(*, verbose=True):
    res = {"cnn": cnn_traffic(), "lm": lm_traffic()}
    if verbose:
        print("[traffic] CNN (accesses in millions, batch=50):")
        for net, r in res["cnn"].items():
            print(f"  {net:14s} single: W={r['single']['weights_M']:8.1f} "
                  f"D={r['single']['data_M']:8.1f} | batch: "
                  f"W={r['batch']['weights_M']:8.1f} "
                  f"D={r['batch']['data_M']:8.1f}")
        print("[traffic] LM (accesses in billions):")
        for arch, r in res["lm"].items():
            d = r["decode_per_token"]
            print(f"  {arch:26s} prefill W={r['prefill']['weights_G']:8.2f} "
                  f"D={r['prefill']['data_G']:8.2f} | decode/tok "
                  f"W={d['weights_G']:7.2f} D={d['data_G']:7.2f}")
    save_json("traffic.json", res)
    return res


if __name__ == "__main__":
    run_accounting()
