"""Quickstart on the PyTorch/CUDA port (``repro_torch``): the paper's
pipeline end to end, as ``quickstart.py`` runs it.

1.  Train a small LM with quantized activations (|A|=16) and periodic
    weight clustering (|W|=256, Laplacian-L1), the step donated.
2.  Export the weights to codebook-index form (§4) + memory report.
3.  Serve a few tokens from the compressed network.

    PYTHONPATH=src python examples/quickstart_torch.py [--device {cuda,cpu}]

Without ``--device`` it runs on the GPU and fails without one.
"""

import argparse
import dataclasses

import repro_torch.configs as configs
from repro_torch.core.export import memory_report
from repro_torch.core.quantizer import codebook_indices
from repro_torch.launch.train import TrainLoopConfig, train
from repro_torch.models.model_zoo import build
from repro_torch.serving import ServeEngine, to_codebook_params

PROMPT = [5, 6, 7, 8]


def quickstart_config(levels=16, n_weights=256, interval=20):
    """The reduced qwen3 at |A| ``levels``, |W| ``n_weights``
    (laplacian_l1, the event every ``interval`` steps)."""
    cfg = configs.get("qwen3-1.7b").reduced().quantized(levels=levels,
                                                        n_weights=n_weights)
    return cfg.replace(wq=dataclasses.replace(cfg.wq, method="laplacian_l1",
                                              interval=interval))


def train_model(cfg, steps=80, batch=8, seq=64, lr=3e-3, device=None):
    """``launch.train.train``; returns (params, qstate, history)."""
    print(f"== training {cfg.name} (reduced) with |A|={cfg.act_levels}, "
          f"|W|={cfg.wq.num_weights} ==")
    loop = TrainLoopConfig(steps=steps, batch=batch, seq=seq, lr=lr,
                           device=device)
    params, qstate, history = train(cfg, loop)
    print(f"loss: {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")
    return params, qstate, history


def export(cfg, params, qstate):
    """The §4 export: index form with its memory row printed; returns
    (the report, the index-form params the engine serves)."""
    print("\n== §4 export: codebook indices + memory accounting ==")
    idx_tree, _ = codebook_indices(params, cfg.wq, qstate)
    report = memory_report(idx_tree, cfg.wq.num_weights, cfg.act_levels)
    print(report.row())
    return report, to_codebook_params(params, cfg.wq, qstate, min_size=1024)


def serve(cfg, cparams, max_new=12, device=None) -> list:
    """``max_new`` greedy tokens after ``PROMPT``."""
    print("\n== serving from the compressed network ==")
    engine = ServeEngine(build(cfg), cparams, max_len=48, device=device)
    out = engine.generate([PROMPT], max_new=max_new)[0]
    print("prompt [5,6,7,8] ->", out[len(PROMPT):])
    return out[len(PROMPT):]


def main(argv=None) -> dict:
    """Runs the example; returns its history, memory report and tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run; unset = the GPU (fails without one)")
    args = ap.parse_args(argv)
    cfg = quickstart_config()
    params, qstate, history = train_model(cfg, device=args.device)
    report, cparams = export(cfg, params, qstate)
    tokens = serve(cfg, cparams, device=args.device)
    return {"history": history, "report": report, "tokens": tokens}


if __name__ == "__main__":
    main()
