"""Evaluation CLI of the port, the counterpart of
``feartracker_tpu/evaluate/cli.py``:

    python -m feartracker_tpu_torch.evaluate.cli macs
    python -m feartracker_tpu_torch.evaluate.cli --device cuda fps --streams 64
    python -m feartracker_tpu_torch.evaluate.cli --device cuda eval --root /data/got10k --subset val

``--device`` (default ``cuda``, with no fallback: without a card the first
CUDA tensor raises; ``--device cpu`` runs the plain twins) is where the
trackers run; ``macs`` always counts on the CPU. ``--weights_path`` takes
every format ``convert.load.load_variables`` reads: an ``.npz`` archive of
the JAX package or a bare zoo name, a reference Lightning ``.ckpt``, or the
reference's CoreML ``.mlmodel``; it defaults to ``$FEAR_WEIGHTS``, else the
packaged ``fear_xs.npz``. ``eval --plot`` / ``--plot_precision``
write the OPE success / precision plots (PNG, with matplotlib).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from feartracker_tpu_torch.convert.load import default_weights_path
from feartracker_tpu_torch.data.sequence import DATASET_REGISTRY
from feartracker_tpu_torch.models.fbnet import TRUNKS


def _load(args):
    """A float32 ``FEARNet`` from ``--weights_path`` in any format
    ``load_variables`` reads, shaped by
    ``--model_name/--adjust_channels/--towernum``."""
    from feartracker_tpu_torch.convert.load import load_fear_net, load_variables
    from feartracker_tpu_torch.models.fear_net import FEARNet

    ch, tn = args.adjust_channels, args.towernum
    model = FEARNet(TRUNKS[args.model_name], adjust_channels=ch, towernum=tn)
    return load_fear_net(model, load_variables(args.weights_path, channels=ch, towernum=tn,
                                               trust_pickle=args.trust_checkpoint))


def cmd_macs(args) -> None:
    from feartracker_tpu_torch.evaluate.flops import track_cost

    print(json.dumps(track_cost(_load(args))))


def _video(path: str, n: int) -> np.ndarray:
    """``n`` RGB frames of ``path`` (``utils.video.read_video``: a ``.npy``,
    or a video cv2 decodes), or seeded noise frames (256×480) when no path
    is given, when a video needs cv2 and it is not installed, or when the
    file holds fewer than ``n`` frames (as the JAX CLI does). A ``.npy``
    that cannot be read raises."""
    from feartracker_tpu_torch.utils.video import read_video

    frames = None
    if path:
        try:
            frames = read_video(path, max_frames=n)
        except ImportError:
            pass
    if frames is not None and len(frames) == n:
        return frames
    return np.random.RandomState(0).randint(0, 255, (n, 256, 480, 3), dtype=np.uint8)


def cmd_fps(args) -> None:
    from feartracker_tpu_torch.evaluate import fps as F
    from feartracker_tpu_torch.tracker.runtime import ScanTracker

    tracker = ScanTracker(_load(args), dtype=torch.bfloat16, device=args.device,
                          dynamic_template=args.dynamic_template,
                          update_interval=args.update_interval, trunk_impl=args.trunk_impl)
    S, T = args.streams, args.chunk
    video = torch.from_numpy(_video(args.video_path, T + 1)).to(args.device)
    frames0 = video[0].expand(S, *video.shape[1:])
    chunk = video[1:, None].expand(T, S, *video.shape[1:])
    bboxes = torch.tensor([[163.0, 53.0, 45.0, 174.0]]).repeat(S, 1)

    holder = {"state": tracker.init(frames0, bboxes), "t": 0}

    def call():
        holder["state"], outs = tracker.track(holder["state"], chunk, start_step=holder["t"])
        holder["t"] += T
        return outs

    def sync(outs):
        outs["bbox"][-1].cpu()

    if args.protocol == "fps":
        res = F.fps_benchmark(call, sync, csv_path=args.csv, device=args.device)
        res["tracked_fps"] = res["fps"] * S * T
        print(json.dumps(res))
        return
    for _ in range(args.warmup_calls):
        sync(call())
    kw = dict(duration_s=args.duration, csv_path=args.csv, device=args.device)
    if args.protocol == "online":
        res = F.online_benchmark(call, sync, input_fps=args.input_fps, **kw)
    elif args.protocol == "online_pipelined":
        res = F.pipelined_online_benchmark(call, sync, input_fps=args.input_fps,
                                           depth=args.pipeline_depth, **kw)
    else:
        res = F.offline_benchmark(call, sync, fps=args.input_fps, **kw)
    print(json.dumps(res))


def cmd_eval(args) -> None:
    """Sequence-dataset evaluation or submission for any registry dataset."""
    from feartracker_tpu_torch.tracker.config import TrackerConfig

    cls = DATASET_REGISTRY[args.dataset]
    kwargs = {"subset": args.subset} if args.dataset in ("got10k", "trackingnet") else {}
    dataset = cls(args.root, **kwargs)
    cfg = TrackerConfig(smooth=args.smooth)
    rec = {"recover_context": args.recover_context}
    if args.batched and args.submit_dir:
        raise SystemExit("--submit_dir requires the sequential tracker; drop --batched")
    if args.supervised and (args.batched or args.submit_dir):
        raise SystemExit("--supervised runs the sequential re-init protocol; drop --batched/--submit_dir")
    if args.batched:
        from feartracker_tpu_torch.evaluate.batched_eval import batched_evaluate
        from feartracker_tpu_torch.tracker.runtime import ScanTracker

        tracker = ScanTracker(_load(args), cfg, dtype=torch.bfloat16, device=args.device, **rec)
        res = batched_evaluate(
            tracker, dataset, streams=args.streams, max_frames=args.max_frames,
            max_sequences=args.max_sequences, verbose=True,
        )
    else:
        from feartracker_tpu_torch.tracker.tracker import FEARTracker

        writers = {}
        if args.submit_dir:
            from feartracker_tpu_torch.evaluate.got10k_eval import (
                write_got10k_submission,
                write_trackingnet_submission,
            )

            writers = {"got10k": write_got10k_submission, "trackingnet": write_trackingnet_submission}
            if args.dataset not in writers:
                raise SystemExit(f"--submit_dir supports {sorted(writers)}, not {args.dataset!r}")
        tracker = FEARTracker(_load(args), cfg, device=args.device, **rec)
        if args.supervised:
            from feartracker_tpu_torch.evaluate.vot_eval import evaluate_vot

            res = evaluate_vot(tracker, dataset, max_frames=args.max_frames, verbose=True)
        elif args.submit_dir:
            out = writers[args.dataset](
                tracker, dataset, args.submit_dir, max_frames=args.max_frames, verbose=True
            )
            res = {"submission_dir": out, "num_sequences": len(dataset)}
        else:
            from feartracker_tpu_torch.evaluate.got10k_eval import evaluate_tracker

            res = evaluate_tracker(
                tracker, dataset, max_frames=args.max_frames,
                max_sequences=args.max_sequences, verbose=True,
            )
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump(res, fh, indent=1)
    if args.plot or args.plot_precision:
        _plot(args, res)
    curves = ("per_sequence", "success_curve", "precision_curve", "norm_precision_curve")
    print(json.dumps({k: v for k, v in res.items() if k not in curves}))


def _plot(args, res) -> None:
    """``--plot`` / ``--plot_precision``: the run's OPE curves as PNGs, the
    series named after the weights file."""
    from feartracker_tpu_torch.evaluate.plots import plot_precision, plot_success

    if "success_curve" not in res:
        raise SystemExit("--plot/--plot_precision need OPE curves (AO-style eval, not --supervised/--submit_dir)")
    name = os.path.splitext(os.path.basename(args.weights_path.rstrip("/")))[0]
    if args.plot:
        os.makedirs(os.path.dirname(args.plot) or ".", exist_ok=True)
        plot_success({name: res["success_curve"]}, args.plot, title=f"Success plot (OPE) — {args.dataset}")
    if args.plot_precision:
        if "precision_curve" not in res:
            raise SystemExit("--plot_precision: no precision curve (no scored sequences)")
        os.makedirs(os.path.dirname(args.plot_precision) or ".", exist_ok=True)
        plot_precision({name: res["precision_curve"]}, args.plot_precision,
                       title=f"Precision plot (OPE) — {args.dataset}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="where the trackers run: 'cuda' (the kernels; the default) or 'cpu' (their plain twins)")
    p.add_argument("--weights_path", default=default_weights_path(),
                   help="an .npz variables archive of the JAX package or a bare zoo name, a reference Lightning "
                        ".ckpt, or the reference's CoreML .mlmodel (default: $FEAR_WEIGHTS, else the packaged "
                        "fear_xs.npz)")
    p.add_argument("--trust_checkpoint", action="store_true",
                   help="unpickle a .ckpt that holds more than tensors and plain values in full (runs the code it "
                        "names: only for checkpoints you trust)")
    p.add_argument("--model_name", choices=sorted(TRUNKS), default="fear_xs")
    p.add_argument("--adjust_channels", type=int, default=256)
    p.add_argument("--towernum", type=int, default=2)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("macs")

    fp = sub.add_parser("fps")
    fp.add_argument("--protocol", choices=["fps", "online", "online_pipelined", "offline"], default="fps")
    fp.add_argument("--pipeline_depth", type=int, default=2)
    fp.add_argument("--warmup_calls", type=int, default=1,
                    help="un-timed calls before the online/offline protocols")
    fp.add_argument("--streams", type=int, default=64)
    fp.add_argument("--chunk", type=int, default=64, help="frames per call")
    fp.add_argument("--duration", type=float, default=30.0)
    fp.add_argument("--input_fps", type=float, default=30.0)
    fp.add_argument("--video_path", default="",
                    help="a .npy of (T, H, W, 3) uint8 frames, or a video read with cv2 when it is installed; "
                         "else seeded noise frames")
    fp.add_argument("--csv", default=None)
    fp.add_argument("--dynamic_template", action="store_true")
    fp.add_argument("--update_interval", type=int, default=1)
    fp.add_argument("--trunk_impl", choices=["xla", "fused"], default="fused",
                    help="'fused' = the folded trunk with the fused block kernel (the default); "
                         "'xla' = the model's own unfolded trunk on cuDNN")

    # `got10k` kept as an alias of `eval --dataset got10k`
    for cmd_name in ("got10k", "eval"):
        gp = sub.add_parser(cmd_name)
        if cmd_name == "eval":
            gp.add_argument("--dataset", choices=sorted(DATASET_REGISTRY), default="got10k")
        gp.add_argument("--root", required=True)
        gp.add_argument("--subset", default="val")
        gp.add_argument("--max_frames", type=int, default=None)
        gp.add_argument("--max_sequences", type=int, default=None)
        gp.add_argument("--smooth", action="store_true")
        gp.add_argument("--batched", action="store_true", help="multi-stream ScanTracker (bfloat16)")
        gp.add_argument("--supervised", action="store_true",
                        help="VOT supervised protocol (re-init on failure): accuracy/robustness/EAO")
        gp.add_argument("--streams", type=int, default=64)
        gp.add_argument("--recover_context", type=float, default=0.0,
                        help="zoom-out re-acquisition context after a low-confidence frame (0 = off)")
        gp.add_argument("--submit_dir", default=None, help="write eval-server submission files here")
        gp.add_argument("--report", default=None,
                        help="also write the full result (incl. per-sequence) as JSON here")
        gp.add_argument("--plot", default=None, help="write an OPE success plot (PNG) here")
        gp.add_argument("--plot_precision", default=None, help="write an OPE precision plot (PNG) here")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.cmd == "got10k":
        args.dataset = "got10k"
    {"macs": cmd_macs, "fps": cmd_fps, "got10k": cmd_eval, "eval": cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    main()
