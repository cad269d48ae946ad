"""Gate v2: train the feature-conditioned dual-template update gate, the
counterpart of ``tools/train_feature_gate.py``.

A tiny MLP over the per-frame observable vector (``models/gate.py``) sets each
stream's EMA rate every frame. Supervision comes from the synthetic
generator's analytic visibility (``cover.label``, GOT-10k's visible-ratio
bins): a frame's template candidate is safe to blend iff the target is
visible there and the predicted box is on it,

    label_t = [visible_t >= vis_thresh] AND [IoU(pred_t, gt_t) >= iou_thresh].

Collection rolls the production EMA@1 tracker (``build_scan_tracker``,
``update_interval=1``: K1 a step, K2 13 a step and 13 a refresh, every step
a refresh) over swap / pose / occlusion / drift rollouts on train seeds
disjoint from the pre-registered evaluation seeds (7, 13, 21, 29, 37) and
reads the runtime's ``gate_obs``; the JAX tool's ``postprocess_impl="xla"``
decode is the one K1's region computes. The MLP trains with class-balanced
BCE (Adam, full batch) on the collection's device; the report holds train and held-out AUC and accuracy. The gate
goes to ``--out`` (default ``<work>/fear_xs_feature_gate.npz``).

    python -m feartracker_tpu_torch.tools.train_feature_gate --work /tmp/gate_v2
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from feartracker_tpu_torch.core.geometry_np import overlap_xywh_np
from feartracker_tpu_torch.data.dataset import read_img
from feartracker_tpu_torch.data.sequence import GOT10kDataset
from feartracker_tpu_torch.evaluate.harness import DTYPES, build_scan_tracker, device_line, tool_device
from feartracker_tpu_torch.models.gate import gate_logit, gate_rate, init_gate_params, save_gate
from feartracker_tpu_torch.tools.make_synthetic_dataset import generate
from feartracker_tpu_torch.train.optim import apply_updates, build_optimizer

SCENARIOS = ("swap", "pose", "occlusion", "drift")
EVAL_SEEDS = {7, 13, 21, 29, 37}


def collect_rollouts(scenarios, seeds, frames, sequences, drift, work, chunk=16, dtype=torch.bfloat16,
                     device="cuda"):
    """Roll the production EMA@1 tracker → (obs (N, 6), vis (N,), iou (N,),
    scenario tag (N,) int, weights provenance, pred boxes (N, 4)). One
    tracker serves every dataset."""
    tracker, prov = build_scan_tracker(dtype=dtype, device=device, dynamic_template=True, update_mode="ema",
                                       update_threshold=0.85, update_rate=0.2, update_interval=1)
    all_obs, all_vis, all_iou, all_tag, all_pred = [], [], [], [], []
    for s_i, scenario in enumerate(scenarios):
        for seed in seeds:
            root = os.path.join(work, f"{scenario}_s{seed}")
            if not os.path.isdir(os.path.join(root, "got10k")):
                generate(root, tracks=1, frames=frames, val_sequences=sequences, seed=seed,
                         appearance_drift=drift if scenario == "drift" else 0.0, scenario=scenario)
            ds = GOT10kDataset(os.path.join(root, "got10k"), subset="val")
            seqs = [ds[i] for i in range(len(ds))]
            covers = []
            for i in range(len(ds)):
                with open(os.path.join(root, "got10k", "val", ds.sequence_name(i), "cover.label")) as fh:
                    covers.append(np.array([int(x) for x in fh.read().split()]) / 8.0)
            T = min(len(f) for f, _, _ in seqs)
            S = len(seqs)
            frames0 = np.stack([read_img(seqs[i][0][0]) for i in range(S)])
            bb0 = np.stack([np.asarray(seqs[i][1][0], np.float32) for i in range(S)])
            state = tracker.init(frames0, bb0)
            t = 1
            while t < T:
                n = min(chunk, T - t)
                batch = np.stack([np.stack([read_img(seqs[i][0][t + k]) for i in range(S)]) for k in range(n)])
                state, out = tracker.track(state, batch, start_step=t - 1)
                obs = out["gate_obs"].float().cpu().numpy()  # (n, S, N_OBS)
                pred = out["bbox"].double().cpu().numpy()  # (n, S, 4)
                for k in range(n):
                    gt = np.stack([np.asarray(seqs[i][1][t + k], np.float64) for i in range(S)])
                    all_obs.append(obs[k])
                    all_vis.append(np.array([covers[i][t + k] for i in range(S)]))
                    all_iou.append(overlap_xywh_np(pred[k], gt))
                    all_tag.append(np.full(S, s_i))
                    all_pred.append(pred[k])
                t += n
    return (np.concatenate(all_obs).astype(np.float32), np.concatenate(all_vis), np.concatenate(all_iou),
            np.concatenate(all_tag), prov, np.concatenate(all_pred))


def auc(y, s) -> float:
    """Rank-based ROC AUC (ties in ``s`` ranked by position, as JAX's)."""
    order = np.argsort(s)
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    n_pos, n_neg = int(y.sum()), int((1 - y).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return (ranks[y > 0].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def train_mlp(obs, labels, hidden, epochs, lr, seed, holdout=0.2, device="cpu"):
    """Class-balanced BCE with logits, Adam, full batch, on ``device``: the
    same ``RandomState(seed)`` draws as JAX (the split's permutation, then
    the initial parameters). → (float32 numpy params, report, final loss)."""
    device = torch.device(device)
    rng = np.random.RandomState(seed)
    n = len(obs)
    perm = rng.permutation(n)
    n_hold = int(n * holdout)
    hold, tr = perm[:n_hold], perm[n_hold:]
    x_tr = torch.as_tensor(obs[tr], dtype=torch.float32, device=device)
    y_tr = torch.as_tensor(labels[tr].astype(np.float32), device=device)
    pos = float(labels[tr].mean())
    w_pos, w_neg = 0.5 / max(pos, 1e-6), 0.5 / max(1 - pos, 1e-6)
    w = y_tr * w_pos + (1 - y_tr) * w_neg

    params = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in init_gate_params(rng, hidden).items()}
    tx = build_optimizer({"name": "adam", "lr": lr})
    opt = tx.init({k: p.detach() for k, p in params.items()})
    loss = None
    for _ in range(epochs):
        ce = F.binary_cross_entropy_with_logits(gate_logit(params, x_tr), y_tr, reduction="none")
        loss = torch.mean(w * ce)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        updates, opt = tx.update(grads, opt, {k: p.detach() for k, p in params.items()})
        apply_updates({k: p.data for k, p in params.items()}, updates)
    params = {k: p.detach().cpu().numpy().astype(np.float32) for k, p in params.items()}

    report = {}
    for name, idx in (("train", tr), ("holdout", hold)):
        s = gate_rate(params, torch.as_tensor(obs[idx], dtype=torch.float32)).numpy()
        y = labels[idx]
        report[name] = {
            "n": int(len(idx)), "pos_rate": round(float(y.mean()), 4),
            "auc": round(auc(y, s), 4),
            "acc@0.5": round(float(((s > 0.5) == (y > 0.5)).mean()), 4),
            "mean_rate_pos": round(float(s[y > 0.5].mean()), 4) if y.max() > 0 else None,
            "mean_rate_neg": round(float(s[y < 0.5].mean()), 4) if y.min() < 1 else None,
        }
    return params, report, float(loss.detach())


def run(out=None, scenarios=SCENARIOS, train_seeds=(51, 52, 53, 54), frames=48, sequences=8, drift=1.0,
        vis_thresh=0.7, iou_thresh=0.5, hidden=8, epochs=3000, lr=3e-2, seed=0, work=None, dump_obs=None,
        dtype=torch.bfloat16, device="cuda") -> list:
    """Collect, label, train and save the gate; the collection record and
    the training report printed as JSON lines. → both records."""
    overlap = EVAL_SEEDS & set(train_seeds)
    if overlap:
        raise SystemExit(f"train seeds {overlap} collide with the pre-registered eval seeds — pick others")
    t0 = time.time()
    work = work or tempfile.mkdtemp(prefix="gate_v2_")
    out = out or os.path.join(work, "fear_xs_feature_gate.npz")
    obs, vis, iou, tag, prov, _ = collect_rollouts(scenarios, train_seeds, frames, sequences, drift, work,
                                                   dtype=dtype, device=device)
    labels = ((vis >= vis_thresh) & (iou >= iou_thresh)).astype(np.float32)
    records = [{"collected": int(len(obs)), "weights": prov, "pos_rate": round(float(labels.mean()), 4),
                "collect_s": round(time.time() - t0, 1),
                "per_scenario_pos": {s: round(float(labels[tag == i].mean()), 4) for i, s in enumerate(scenarios)}}]
    print(json.dumps(records[-1]), flush=True)
    if dump_obs:
        np.savez(dump_obs, obs=obs, vis=vis, iou=iou, tag=tag, labels=labels)
    params, report, final_loss = train_mlp(obs, labels, hidden, epochs, lr, seed, device=device)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_gate(params, out)
    records.append({"gate": out, "final_loss": round(final_loss, 4), **report, "wall_s": round(time.time() - t0, 1)})
    print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="default: <work>/fear_xs_feature_gate.npz")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--train_seeds", default="51,52,53,54",
                    help="generator seeds — MUST stay disjoint from the pre-registered eval seeds 7,13,21,29,37")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--vis_thresh", type=float, default=0.7)
    ap.add_argument("--iou_thresh", type=float, default=0.5)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work", "--root", default=None, help="where the rollout datasets go (default: temporary)")
    ap.add_argument("--device", "--platform", default=None, help="default: BENCH_DEVICE, else the card")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--dump_obs", default=None,
                    help="also save the raw (obs, vis, iou, tag) matrices as npz for analysis")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print(device_line(device), flush=True)
    run(args.out, args.scenarios.split(","), [int(s) for s in args.train_seeds.split(",")], args.frames,
        args.sequences, args.drift, args.vis_thresh, args.iou_thresh, args.hidden, args.epochs, args.lr, args.seed,
        args.work, args.dump_obs, DTYPES[args.dtype], device)


if __name__ == "__main__":
    main()
