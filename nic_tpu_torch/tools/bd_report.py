"""BD-PSNR report: measured RD curves against the reference's golden curves
(counterpart of scripts/bd_report.py; the curves are in
``nic_tpu_torch/evaluation/golden.py``).

  python -m nic_tpu_torch.tools.bd_report RESULTS_DIR [--dataset kodak]
      [--methods amortized:mbt2018,sga:sga]

RESULTS_DIR holds the <name>-psnr.csv files that ``tools/rd_curve.py``
writes. Each "csvname:goldenmethod" pair names a curve file and the golden
curve it is held against (amortized inference corresponds to the
reference's mbt2018 curve). For each pair it prints, as a markdown table on
stdout, the PSNR delta at equal rate at every point and their average.
Negative deltas mean the reference is ahead at that rate. The output is
nic_tpu's, byte for byte. No model runs, so there is no ``--device``.
"""

import argparse
import json
import os

from nic_tpu_torch.evaluation.golden import GOLDEN_RD, bd_psnr_gap, interp_psnr_at_bpp


def load_csv(path):
    """The (bpp, psnr) rows of a <name>-psnr.csv file, sorted."""
    pts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                b, p = line.split(",")
                pts.append((float(b), float(p)))
    return sorted(pts)


def eval_set_label(results_dir):
    """", eval set: <names>" from the rd_curve.json beside the CSVs, or ""."""
    try:
        with open(os.path.join(results_dir, "rd_curve.json")) as f:
            evals = {r.get("eval") for r in json.load(f)} - {None}
    except (OSError, ValueError):
        return ""
    return f", eval set: {'+'.join(sorted(evals))}" if evals else ""


def main(argv=None):
    """Print the report; returns {csvname: {"points", "deltas", "gap"}} of
    the curves found."""
    ap = argparse.ArgumentParser()
    ap.add_argument("results_dir")
    ap.add_argument("--dataset", default="kodak", choices=sorted(GOLDEN_RD))
    ap.add_argument(
        "--methods",
        default="amortized:mbt2018,sga:sga",
        help="comma list of <csvname>:<golden-method> pairs",
    )
    args = ap.parse_args(argv)

    # The header names both sides: the results directory (and its eval set)
    # and the golden dataset.
    print(f"## BD-PSNR: {args.results_dir}{eval_set_label(args.results_dir)} "
          f"vs golden {args.dataset}\n")
    print("| curve | golden ref | points | per-point dPSNR @ equal bpp (dB) | avg gap (dB) |")
    print("|---|---|---|---|---|")
    report = {}
    for pair in args.methods.split(","):
        csvname, gmethod = pair.split(":")
        path = os.path.join(args.results_dir, f"{csvname}-psnr.csv")
        if not os.path.exists(path):
            print(f"| {csvname} | {gmethod} | — | (no {path}) | — |")
            continue
        pts = load_csv(path)
        deltas = [p - interp_psnr_at_bpp(args.dataset, gmethod, b) for b, p in pts]
        gap = bd_psnr_gap(args.dataset, gmethod, pts)
        dstr = ", ".join(f"{d:+.2f}@{b:.3f}bpp" for (b, _), d in zip(pts, deltas))
        print(f"| {csvname} | {gmethod} | {len(pts)} | {dstr} | {gap:+.3f} |")
        report[csvname] = dict(points=pts, deltas=deltas, gap=gap)
    print(
        "\nNegative = reference ahead at that rate (expected until parity);"
        " gaps should shrink toward 0 as training lengthens."
    )
    return report


if __name__ == "__main__":
    main()
