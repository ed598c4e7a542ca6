"""Training with periodic in-process ground-truth validation (port of the
reference package's ``train_flow_validation.py``)::

    python -m evflow_torch.train_flow_validation --config configs/train_SNN.yml \\
        --val_config configs/eval_MVSEC.yml --val_every 5

Every ``--val_every`` epochs the live model is evaluated on the validation
config (its model section replaced by the training one) inside the
training process; the best validation AAE (AEE without AAE) keeps a
``best_val_aae`` checkpoint with the optimizer state beside the training
policies' checkpoints. ``evaluate`` builds its own state carries and runs
the model in eval mode; the next training step puts it back in training
mode, its carries untouched.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/train_SNN.yml")
    parser.add_argument("--val_config", default="configs/eval_MVSEC.yml")
    parser.add_argument("--path_runs", default="runs")
    parser.add_argument("--prev_runid", default="", help="port checkpoint to resume from")
    parser.add_argument("--val_every", type=int, default=5, help="epochs between validations")
    parser.add_argument("--val_max_windows", type=int, default=None,
                        help="cap validation windows (smoke tests)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N train steps (smoke tests)")
    parser.add_argument("--val_chunk", type=int, default=1,
                        help="run K validation windows as one dispatch")
    parser.add_argument("--val_device_metrics", action="store_true",
                        help="compute validation metrics on the device (needs --val_chunk > 1)")
    parser.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    import numpy as np

    from evflow_torch.config import load_config
    from evflow_torch.eval import evaluate
    from evflow_torch.train import train
    from evflow_torch.utils.checkpoint import save_checkpoint

    config = load_config(args.config)
    val_config = load_config(args.val_config)
    val_config["model"] = dict(config["model"])
    best = {"val_aae": float("inf")}

    def validate(epoch, model, run, optimizer):
        if args.val_every <= 0 or (epoch + 1) % args.val_every != 0:
            return
        results = evaluate(val_config, model=model, debug=True, max_windows=args.val_max_windows,
                           chunk=args.val_chunk, device_metrics=args.val_device_metrics,
                           device=args.device)
        vals = {}
        for mname in ("AAE", "AEE"):
            xs = [float(v) for v in results.get(mname, {}).values()]
            if xs:
                vals[mname] = float(np.mean(xs))
                run.log_metric(f"val_{mname}", vals[mname], step=epoch)
        val_aae = vals.get("AAE", vals.get("AEE", float("inf")))
        print(f"epoch {epoch}: validation {vals}")
        if val_aae < best["val_aae"]:
            best["val_aae"] = val_aae
            dst = os.path.join(run.dir, "checkpoints", "best_val_aae", str(epoch))
            save_checkpoint(dst, {"model_state_dict": model.state_dict(),
                                  "optimizer_state_dict": optimizer.state_dict(),
                                  "epoch": epoch, "loss": 0.0, "loss_variance": 0.0}, config)
            base = os.path.dirname(dst)
            for d in os.listdir(base):  # only the newest best_val_aae stays
                if d != str(epoch):
                    shutil.rmtree(os.path.join(base, d), ignore_errors=True)
            print(f"  new best val AAE {val_aae:.4f} -> {dst}")

    run = train(config, path_runs=args.path_runs, prev_ckpt=args.prev_runid or None,
                max_steps=args.max_steps, epoch_callback=validate, device=args.device)
    print(f"best val AAE: {best['val_aae']:.4f} (run {run.dir})")
    return run, best


if __name__ == "__main__":
    main()
