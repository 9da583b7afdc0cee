"""End to end on the PyTorch/CUDA port (``repro_torch``): train a
~100M-parameter LM for a few hundred steps with the paper's technique
enabled, checkpointing, and a resume test, as ``train_lm_100m.py`` runs
it.

93.6M params (d=640, 10 layers, ff=2560, vocab 50k, qwen3-style blocks),
counted on the meta device (``launch/steps.abstract_params``).  A second
run on the same ``--ckpt-dir`` resumes from its latest checkpoint.

    PYTHONPATH=src python examples/train_lm_100m_torch.py --steps 200
        [--device {cuda,cpu}]

Without ``--device`` it runs on the GPU and fails without one.
"""

import argparse
import math
import os
import tempfile

import repro_torch.configs as configs
from repro_torch.core.quantizer import WeightQuantConfig
from repro_torch.launch.steps import abstract_params
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.models.model_zoo import build
from repro_torch.tree import leaves


def lm_config(n_layers=10, d_model=640, d_ff=2560, n_heads=10, n_kv=5,
              head_dim=64, vocab=50048, interval=100):
    """The 93.6M-param qwen3-style config: f32, |A| 32, |W| 1000
    laplacian_l1 every ``interval`` steps."""
    return configs.get("qwen3-1.7b").replace(
        name="qwen3-100m", n_layers=n_layers, d_model=d_model, d_ff=d_ff,
        n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, vocab=vocab,
        dtype="float32", act_levels=32,
        wq=WeightQuantConfig(num_weights=1000, method="laplacian_l1",
                             interval=interval),
        microbatches=1)


def count_params(cfg) -> int:
    """Parameters of ``cfg`` from their shapes on the meta device; prints
    the banner."""
    n = sum(math.prod(x.shape) for x in leaves(abstract_params(build(cfg))))
    print(f"== {cfg.name}: {n / 1e6:.1f}M params, |A|=32, |W|=1000, "
          f"cluster every {cfg.wq.interval} steps ==")
    return n


def run(cfg, steps=200, batch=8, seq=256, ckpt_dir="", ckpt_every=100,
        log_every=20, device=None):
    """``launch.train.train`` with checkpoints every ``ckpt_every`` steps
    into ``ckpt_dir`` (resuming from its latest); prints the last history
    entry and the codebook.  Returns (params, qstate, history)."""
    loop = TrainLoopConfig(steps=steps, batch=batch, seq=seq, lr=1e-3,
                           ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                           log_every=log_every, device=device)
    params, qstate, history = train(cfg, loop)
    print("final:", history[-1])
    if qstate.codebooks:
        print(f"codebook: {qstate.codebooks[''].shape[0]} unique weights "
              f"(last clustered at step {qstate.last_step})")
    else:
        print(f"(no clustering event yet — fires every "
              f"{cfg.wq.interval} steps)")
    return params, qstate, history


def main(argv=None) -> dict:
    """Runs the example; returns the counted params and the run's
    (params, qstate, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_lm100m"))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run; unset = the GPU (fails without one)")
    args = ap.parse_args(argv)
    cfg = lm_config()
    n = count_params(cfg)
    params, qstate, history = run(cfg, args.steps, args.batch, args.seq,
                                  args.ckpt_dir, device=args.device)
    return {"n_params": n, "params": params, "qstate": qstate,
            "history": history}


if __name__ == "__main__":
    main()
