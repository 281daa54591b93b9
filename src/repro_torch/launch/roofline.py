"""Roofline table from the dry-run's records (port of
``repro.launch.roofline``).

Reads ``<out>/*.json`` (written by ``launch/dryrun.py``), computes the
three roofline terms of each (arch x shape x mesh) cell on a part's
constants (:class:`repro_torch.core.energy.HW`, :data:`H100` unless
given), names the dominant term, and prints a markdown table or CSV.
Every number is the model's prediction for that part, never a
measurement.

Conventions (the reference's):
  * flops / traffic are PER-CHIP (one rank's step, counted by
    ``launch/opcount.py``);
  * the collective term takes the per-chip operand bytes over the
    part's ``ici_links`` links of ``ici_bw`` each;
  * MODEL_FLOPS: train = 6*N*D (dense) / 6*N_active*D (MoE), counted
    per step including grad-accum microbatching; prefill = 2*N*D;
    decode = 2*N per token * batch.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.core.energy import H100, RooflineTerms, roofline_terms

__all__ = ["load_records", "model_flops", "roofline_row", "make_table",
           "to_markdown", "hw_label", "main"]


def load_records(outdir="artifacts/dryrun"):
    recs = []
    for p in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("status") == "ok":
            recs.append(r)
    return recs


def model_flops(rec) -> float:
    n = rec["active_params"]
    toks = rec["seq_len"] * rec["global_batch"]
    if rec["kind"] == "train":
        return 6.0 * n * toks
    if rec["kind"] == "prefill":
        return 2.0 * n * toks
    return 2.0 * n * rec["global_batch"]  # decode: one token per row


def _suggestion(rec, terms: RooflineTerms) -> str:
    b = terms.bottleneck
    if b == "compute":
        return ("compute-bound: raise per-chip arithmetic efficiency "
                "(fuse attention, drop remat recompute, bf16 everywhere)")
    if b == "memory":
        if rec["kind"] == "decode":
            return ("HBM-bound on KV/weight reads: quantize KV cache, "
                    "fuse decode attention, batch more requests per chip")
        return ("HBM-bound: larger microbatches per chip / flash-style "
                "attention fusion / selective remat to cut activation "
                "round-trips")
    return ("collective-bound: overlap collectives with compute, shrink "
            "TP degree for this arch, or compress cross-pod grads")


def roofline_row(rec, hw=H100):
    chips = rec["chips"]
    w = rec["weighted"]
    flops_chip = w["flops_per_chip"]
    traffic_chip = w["traffic_bytes_per_chip"]
    coll_chip = w["collectives"]["total_bytes"]
    terms = roofline_terms(
        flops_chip * chips, traffic_chip * chips, coll_chip, chips, hw=hw)
    mf = model_flops(rec)
    frac = terms.fraction_of_roofline(mf, chips, hw)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"], "chips": chips,
        "t_compute": terms.t_compute, "t_memory": terms.t_hbm,
        "t_collective": terms.t_ici,
        "bottleneck": terms.bottleneck,
        "model_flops": mf,
        "hlo_flops": flops_chip * chips,
        "useful_ratio": mf / max(flops_chip * chips, 1e-9),
        "roofline_fraction": frac,
        "suggestion": _suggestion(rec, terms),
        "grad_accum": rec.get("grad_accum"),
    }


def make_table(outdir="artifacts/dryrun", mesh="single", hw=H100):
    rows = [roofline_row(r, hw) for r in load_records(outdir)
            if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    return rows


def to_markdown(rows):
    hdr = ("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | MODEL/HLO | roofline frac |")
    sep = "|" + "---|" * 8
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.4f} | "
            f"{r['t_memory']:.4f} | {r['t_collective']:.4f} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.1%} |")
    return "\n".join(out)


def hw_label(hw=H100) -> str:
    """What the table's times are: the named part's model, with the
    constants it used."""
    return (f"{hw.name} model (predicted, not measured): peak_flops="
            f"{hw.peak_flops:.4g} FLOP/s, hbm_bw={hw.hbm_bw:.4g} B/s, "
            f"ici_bw={hw.ici_bw:.4g} B/s x {hw.ici_links} links")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = make_table(args.out, args.mesh)
    print(f"# {args.mesh} mesh, {hw_label()}")
    if args.markdown:
        print(to_markdown(rows))
    else:
        for r in rows:
            print(f"{r['arch']},{r['shape']},{r['mesh']},"
                  f"{r['t_compute']:.5f},{r['t_memory']:.5f},"
                  f"{r['t_collective']:.5f},{r['bottleneck']},"
                  f"{r['roofline_fraction']:.4f}")


if __name__ == "__main__":
    main()
