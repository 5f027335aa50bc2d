"""Training-log plotting CLI: the port's copy of ``ic_gan_tpu/cli/plot_logs.py``,
the reference's MATLAB log-processing utilities rebuilt on the logs the
port's trainers write (``BigGAN_PyTorch/logs/process_training.m``,
``process_inception_log.m``, ``compare_IS.m``).

Three modes over a BigGAN run's logs directory (``logs_root/experiment_name``,
where ``train/trainer.py`` writes ``<name>_log.jsonl``,
``<name>_test_log.jsonl`` and the per-metric ``<metric>.log`` files):

- ``training`` — losses (raw + smoothed, the reference overlays a wavelet
  denoise; we use a centred moving average) and the per-layer spectral-norm
  singular-value trajectories for G and D (``process_training.m:57-120``).
- ``inception`` — IS/FID trajectory from the test jsonl
  (``process_inception_log.m``: parses ``{"itr": .., "IS_mean": ..,
  "FID": ..}`` lines).
- ``compare`` — overlay IS and FID across several run dirs, ranked by best
  IS / min FID with an optional IS threshold (``compare_IS.m:40-49``).

``stylegan2_series`` reads a StyleGAN2 run directory
(``train/stylegan2_trainer.py``: ``stats.jsonl`` by tick, ``metric-fid.jsonl``
by snapshot) into the same kind of arrays, over kimg.

The readers need numpy only; matplotlib is imported by the plotting
functions alone (``_plt``).

Usage::

    python -m ic_gan_tpu_torch.cli.plot_logs --set logs_dir=logs/exp1
    python -m ic_gan_tpu_torch.cli.plot_logs --set mode=inception logs_dir=logs/exp1
    python -m ic_gan_tpu_torch.cli.plot_logs --set mode=compare runs=logs/a,logs/b
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


# -- log readers -------------------------------------------------------------


def read_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def read_metric_log(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-metric plaintext ``itr: value`` lines (``MetricLogger`` format,
    the reference's ``MyLogger`` — parsed by ``process_training.m:45-50``)."""
    itr, val = [], []
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*(\d+)\s*:\s*([-+0-9.eE]+)", line)
            if m:
                itr.append(int(m.group(1)))
                val.append(float(m.group(2)))
    return np.asarray(itr), np.asarray(val)


def find_train_jsonl(logs_dir: str) -> Optional[str]:
    cands = [
        p for p in glob.glob(os.path.join(logs_dir, "*_log.jsonl"))
        if not p.endswith("_test_log.jsonl")
    ]
    return sorted(cands)[0] if cands else None


def find_test_jsonl(logs_dir: str) -> Optional[str]:
    cands = glob.glob(os.path.join(logs_dir, "*_test_log.jsonl"))
    return sorted(cands)[0] if cands else None


def series_from_jsonl(rows: List[Dict], key: str) -> Tuple[np.ndarray, np.ndarray]:
    itr = [r["itr"] for r in rows if key in r and r.get("itr") is not None]
    val = [float(r[key]) for r in rows if key in r and r.get("itr") is not None]
    return np.asarray(itr), np.asarray(val)


def smooth(v: np.ndarray, window: int) -> np.ndarray:
    """Centred moving average — stands in for ``process_training.m``'s
    ``wden`` wavelet denoise (the smoothed overlay, ``:104-117``)."""
    if window <= 1 or v.size < 3:
        return v
    w = min(int(window) | 1, v.size | 1)  # odd, ≤ length
    k = np.ones(w) / w
    pad = w // 2
    vp = np.pad(v, pad, mode="edge")
    return np.convolve(vp, k, mode="valid")


def stylegan2_series(run_dir: str) -> Dict[str, np.ndarray]:
    """A StyleGAN2 run's tick and snapshot records as arrays over kimg:
    every scalar key of ``stats.jsonl`` (``kimg``, ``sec_per_kimg``,
    ``augment_p``, the losses) and, from ``metric-fid.jsonl``,
    ``snapshot_kimg`` with each metric of its ``results``."""
    out: Dict[str, np.ndarray] = {}
    path = os.path.join(run_dir, "stats.jsonl")
    if os.path.exists(path):
        rows = read_jsonl(path)
        keys = sorted({k for r in rows for k, v in r.items()
                       if k != "_stamp" and isinstance(v, (int, float))})
        for k in keys:
            out[k] = np.asarray([float(r[k]) for r in rows if k in r])
    path = os.path.join(run_dir, "metric-fid.jsonl")
    if os.path.exists(path):
        rows = read_jsonl(path)
        out["snapshot_kimg"] = np.asarray([float(r["snapshot_kimg"]) for r in rows])
        for k in sorted({k for r in rows for k in r.get("results", {})}):
            out[k] = np.asarray([float(r["results"][k]) for r in rows
                                 if k in r.get("results", {})])
    return out


# -- plotting ----------------------------------------------------------------


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# Reference loss colors (process_training.m:71-86): D_loss_real blue,
# D_loss_fake green, G_loss red — light shade raw, full shade smoothed.
LOSS_COLORS = {
    "D_loss_real": ((0.7, 0.7, 1.0), (0.0, 0.0, 1.0)),
    "D_loss_fake": ((0.7, 1.0, 0.7), (0.0, 1.0, 0.0)),
    "G_loss": ((1.0, 0.7, 0.7), (1.0, 0.0, 0.0)),
}


def plot_training(logs_dir: str, out_dir: str, smooth_window: int = 51,
                  loss_ylim: Optional[Tuple[float, float]] = None) -> List[str]:
    """Losses + G/D singular values (``process_training.m``).

    Losses come from the train jsonl (and any ``<loss>.log`` files); SVs from
    ``G_sv/…``/``D_sv/…`` jsonl keys (the ``sv_log_interval`` stream) or
    ``*sv*.log`` files."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    written = []

    losses: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    svs: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {
        "G": {}, "D": {}}

    train_jsonl = find_train_jsonl(logs_dir)
    if train_jsonl:
        rows = read_jsonl(train_jsonl)
        keys = {k for r in rows for k in r} - {"itr", "_stamp"}
        for k in sorted(keys):
            itr, val = series_from_jsonl(rows, k)
            if not itr.size:
                continue
            if k.startswith("G_sv/"):
                svs["G"][k[len("G_sv/"):]] = (itr, val)
            elif k.startswith("D_sv/"):
                svs["D"][k[len("D_sv/"):]] = (itr, val)
            elif k in LOSS_COLORS:
                losses[k] = (itr, val)
    for path in sorted(glob.glob(os.path.join(logs_dir, "*.log"))):
        name = os.path.splitext(os.path.basename(path))[0]
        if name in LOSS_COLORS and name not in losses:
            losses[name] = read_metric_log(path)
        elif "sv" in name.lower():
            net = "G" if name.startswith("G") else "D"
            svs[net].setdefault(name, read_metric_log(path))

    if losses:
        fig, ax = plt.subplots(figsize=(9, 5))
        for k, (itr, val) in losses.items():
            light, full = LOSS_COLORS[k]
            ax.plot(itr, val, color=light, linewidth=0.8)
            ax.plot(itr, smooth(val, smooth_window), color=full,
                    linewidth=1.8, label=k)
        ax.set_title("Losses")
        ax.set_xlabel("Generator itr")
        ax.set_ylabel("loss")
        if loss_ylim:
            ax.set_ylim(*loss_ylim)
        ax.legend()
        path = os.path.join(out_dir, "losses.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    for net in ("G", "D"):
        if not svs[net]:
            continue
        fig, ax = plt.subplots(figsize=(9, 5))
        cmap = plt.get_cmap("hsv")
        n = max(len(svs[net]), 2)
        for i, (name, (itr, val)) in enumerate(sorted(svs[net].items())):
            ax.plot(itr, val, color=cmap(i / n), linewidth=1.5, label=name)
        ax.set_title(f"Singular Values in {net}")
        ax.set_xlabel("Generator itr")
        ax.set_ylabel("SV")
        if len(svs[net]) <= 24:
            ax.legend(fontsize=6)
        path = os.path.join(out_dir, f"{net}_sv.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    return written


def inception_series(logs_dir: str):
    """itr/IS/FID arrays from a run's test jsonl
    (``process_inception_log.m``'s parse)."""
    path = find_test_jsonl(logs_dir)
    if path is None:
        return None
    rows = read_jsonl(path)
    itr_is, IS = series_from_jsonl(rows, "IS_mean")
    itr_fid, FID = series_from_jsonl(rows, "FID")
    return {"itr_IS": itr_is, "IS": IS, "itr_FID": itr_fid, "FID": FID}


def plot_inception(logs_dir: str, out_dir: str) -> List[str]:
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    ser = inception_series(logs_dir)
    if ser is None or (not ser["IS"].size and not ser["FID"].size):
        return []
    fig, ax1 = plt.subplots(figsize=(9, 5))
    lines = []
    if ser["IS"].size:
        lines += ax1.plot(ser["itr_IS"], ser["IS"], color="tab:blue",
                          linewidth=1.8, label="IS")
        ax1.set_ylabel("IS", color="tab:blue")
    if ser["FID"].size:
        ax2 = ax1.twinx()
        lines += ax2.plot(ser["itr_FID"], ser["FID"], color="tab:red",
                          linewidth=1.8, label="FID")
        ax2.set_ylabel("FID", color="tab:red")
    ax1.set_xlabel("Generator itr")
    ax1.set_title("Inception metrics")
    ax1.legend(lines, [ln.get_label() for ln in lines])
    path = os.path.join(out_dir, "inception.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return [path]


def plot_compare(run_dirs: List[str], out_dir: str,
                 is_threshold: float = 0.0) -> List[str]:
    """Overlay IS/FID across runs, ranked (``compare_IS.m``: sort by max IS /
    min FID, drop runs whose best IS is below the threshold, ``:40-49``)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for d in run_dirs:
        ser = inception_series(d)
        if ser is None or not ser["IS"].size:
            print(f"[plot_logs] {d}: no test jsonl with IS — skipped")
            continue
        best_is = float(ser["IS"].max())
        if best_is <= is_threshold:
            print(f"[plot_logs] {d}: best IS {best_is:.2f} <= threshold "
                  f"{is_threshold} — skipped")
            continue
        min_fid = float(ser["FID"].min()) if ser["FID"].size else float("nan")
        runs.append((os.path.basename(os.path.normpath(d)), ser,
                     best_is, min_fid))
    if not runs:
        return []
    runs.sort(key=lambda r: -r[2])
    print(f"{'run':30s} {'best IS':>9s} {'min FID':>9s}")
    for name, _, best_is, min_fid in runs:
        print(f"{name:30s} {best_is:9.3f} {min_fid:9.3f}")

    written = []
    for metric, idx_key, val_key in (("IS", "itr_IS", "IS"),
                                     ("FID", "itr_FID", "FID")):
        fig, ax = plt.subplots(figsize=(9, 5))
        any_data = False
        for name, ser, _, _ in runs:
            if ser[val_key].size:
                ax.plot(ser[idx_key], ser[val_key], linewidth=1.6, label=name)
                any_data = True
        if not any_data:
            plt.close(fig)
            continue
        ax.set_xlabel("Generator itr")
        ax.set_ylabel(metric)
        ax.set_title(f"{metric} across runs")
        ax.legend(fontsize=8)
        path = os.path.join(out_dir, f"compare_{metric}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None) -> List[str]:
    from ic_gan_tpu_torch.cli.config import parse_args

    cfg = parse_args(argv)
    mode = cfg.get("mode", "training")
    logs_dir = cfg.get("logs_dir", ".")
    out_dir = cfg.get("out_dir") or os.path.join(logs_dir, "plots")
    if mode == "training":
        ylim = cfg.get("loss_ylim")  # e.g. "-1,4" — the MATLAB axis default
        if isinstance(ylim, str):
            lo, hi = ylim.split(",")
            ylim = (float(lo), float(hi))
        written = plot_training(
            logs_dir, out_dir,
            smooth_window=int(cfg.get("smooth_window", 51)),
            loss_ylim=ylim,
        )
    elif mode == "inception":
        written = plot_inception(logs_dir, out_dir)
    elif mode == "compare":
        runs = cfg.get("runs", "")
        run_dirs = runs if isinstance(runs, list) else [
            r for r in str(runs).split(",") if r]
        written = plot_compare(
            run_dirs, out_dir,
            is_threshold=float(cfg.get("is_threshold", 0.0)),
        )
    else:
        raise ValueError(f"unknown mode {mode!r} "
                         "(training | inception | compare)")
    for p in written:
        print(f"[plot_logs] wrote {p}")
    return written


if __name__ == "__main__":
    main()
