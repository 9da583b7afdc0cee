"""Trainer, the port's copy of ``repro/launch/train.py``: the end-to-end
loop with the paper's periodic weight clustering (§2.2), checkpoint/restart
fault tolerance and straggler monitoring, on one device.

    --device {cuda,cpu}   where to run; unset = the GPU (fails without
                          one); cpu runs every kernel's plain version

CPU smoke run:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 6 --quant --cluster-every 3 --device cpu

The same argv without ``--reduced`` and ``--device`` trains the full-width
model on the card.  Each step: the failure injector, the clustering event
when it is due (``cfg.wq.due(step)``, on a generator folded from the seed
and the step), the step's batch from ``TokenPipeline``, the train step
(``launch/steps.py``, donated as the reference's ``jax.jit(...,
donate_argnums=(0, 1))``: the params and moments are updated in place),
the straggler check, the log line and, every ``ckpt_every`` steps, an
async checkpoint (copied to the host before the next step writes the
tensors); a run resumes from the latest complete checkpoint in
``ckpt_dir``.  On the card each step ends with a
synchronize, so its seconds are the step's and not its launches'.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

import repro_torch.configs as configs
from repro_torch import checkpoint as CKPT
from repro_torch.core.quantizer import (QuantizerState, cluster_params,
                                        fold_in, init_state)
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     StragglerMonitor)
from repro_torch.launch import steps as ST
from repro_torch.models.model_zoo import build
from repro_torch.optim import OptConfig, init_opt_state, warmup_cosine

__all__ = ["TrainLoopConfig", "train", "main"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 64
    lr: float = 3e-3
    opt: str = "adamw"
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    device: str | None = None      # None = the GPU (fails without one)


def train(cfg, loop: TrainLoopConfig, injector=None, log=print):
    """Returns (params, quantizer state, history).  Restart-safe."""
    dev = resolve_device(loop.device)
    model = build(cfg)
    ocfg = OptConfig(name=loop.opt, lr=loop.lr,
                     schedule=warmup_cosine(20, loop.steps),
                     moments_dtype=cfg.moments_dtype)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=loop.batch, seq=loop.seq,
                         seed=loop.seed, device=dev)
    injector = injector or FailureInjector()
    monitor = StragglerMonitor(factor=loop.straggler_factor)

    state, qstate, start_step = _start(model, ocfg, loop, dev, log)
    ckpt = CKPT.AsyncCheckpointer(loop.ckpt_dir) if loop.ckpt_dir else None
    step_fn = ST.make_train_step(model, ocfg, donate=True)
    history = []
    try:
        return _loop(cfg, loop, dev, step_fn, state, qstate, start_step,
                     pipe, injector, monitor, ckpt, history, log)
    finally:
        if ckpt:
            # a crash mid-flight must not leave a half-written snapshot
            # unaccounted for: drain the async writer so the atomic rename
            # either completed or never happened
            ckpt.wait()


def _start(model, ocfg, loop, dev, log):
    """({"params", "opt"}, quantizer state, first step): from the seed, or
    from the latest complete checkpoint in ``loop.ckpt_dir``."""
    params = model.init(torch.Generator(device=dev).manual_seed(loop.seed),
                        dev)
    state = {"params": params, "opt": init_opt_state(params, ocfg)}
    qstate = init_state(model.cfg.wq)
    latest = CKPT.latest_step(loop.ckpt_dir) if loop.ckpt_dir else None
    if latest is None:
        return state, qstate, 0
    restored, extra = CKPT.restore(loop.ckpt_dir, latest,
                                   {**state, "codebooks": qstate.codebooks})
    qstate = QuantizerState(codebooks=restored.pop("codebooks"),
                            last_step=extra.get("cluster_step", -1))
    log(f"[resume] from step {extra['step']}")
    return restored, qstate, extra["step"]


def _loop(cfg, loop, dev, step_fn, state, qstate, start_step, pipe,
          injector, monitor, ckpt, history, log):
    # the params and moments are taken out of ``state``, so that no frame
    # but this one holds them: a clustering event's input is freed as
    # ``params`` is rebound
    params, opt_state = state.pop("params"), state.pop("opt")
    for step in range(start_step, loop.steps):
        injector.maybe_fail(step)
        with StragglerMonitor.timer(monitor, time.monotonic) as t:
            # paper §2.2: every `interval` steps, snap all weights to |W|
            # cluster centroids, then keep training unmodified
            if cfg.wq.due(step):
                gen = torch.Generator(device=dev).manual_seed(loop.seed)
                params, qstate = cluster_params(params, cfg.wq, qstate, step,
                                                fold_in(gen, step))
            batch = pipe.batch_at(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if t.straggler:
            log(f"[straggler] step {step}: {t.seconds:.2f}s "
                f"(count={monitor.stragglers})")
        if step % loop.log_every == 0 or step == loop.steps - 1:
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss,
                            "sec": round(t.seconds, 4)})
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        if ckpt and (step + 1) % loop.ckpt_every == 0:
            ckpt.save(step + 1,
                      {"params": params, "opt": opt_state,
                       "codebooks": qstate.codebooks},
                      extra={"step": step + 1,
                             "cluster_step": qstate.last_step})
    if ckpt:
        ckpt.save(loop.steps, {"params": params, "opt": opt_state,
                               "codebooks": qstate.codebooks},
                  extra={"step": loop.steps,
                         "cluster_step": qstate.last_step})
        ckpt.wait()
    return params, qstate, history


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--quant", action="store_true",
                    help="paper working point: |A|=32 acts, |W|=1000 weights")
    ap.add_argument("--act-levels", type=int, default=0)
    ap.add_argument("--n-weights", type=int, default=0)
    ap.add_argument("--cluster-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run; unset = the GPU (fails without one)")
    return ap


def config_of(args):
    """The ModelConfig the argv asks for, as the reference's ``main``
    builds it."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant:
        cfg = cfg.quantized()
    if args.act_levels or args.n_weights:
        from repro_torch.core.quantizer import WeightQuantConfig
        cfg = cfg.replace(
            act_levels=args.act_levels or cfg.act_levels,
            wq=WeightQuantConfig(num_weights=args.n_weights,
                                 interval=args.cluster_every)
            if args.n_weights else cfg.wq)
    if cfg.wq.enabled:
        cfg = cfg.replace(wq=dataclasses.replace(cfg.wq,
                                                 interval=args.cluster_every))
    return cfg


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = config_of(args)
    loop = TrainLoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                           lr=args.lr, opt=args.opt, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, device=args.device)
    t0 = time.time()
    _, qstate, history = train(cfg, loop)
    print(json.dumps({"history": history[-3:],
                      "wall_seconds": round(time.time() - t0, 1),
                      "codebook_sizes": {k: int(v.shape[0]) for k, v in
                                         qstate.codebooks.items()}}))


if __name__ == "__main__":
    main()
