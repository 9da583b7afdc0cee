"""Paper §3.1 on the PyTorch/CUDA port (``repro_torch``): MNIST-style
classification under both quantizations, as ``train_mnist_quantized.py``
runs it.

Trains the same MLP five ways (continuous, |A|=32, |W|=1000, both, and
|W|=100) on ``data/synthetic.pseudo_mnist_batch`` and prints the accuracy
table, the CPU-scale version of the paper's Fig. 6.

    PYTHONPATH=src python examples/train_mnist_quantized_torch.py
        [--device {cuda,cpu}]

Without ``--device`` it runs on the GPU and fails without one.
"""

import argparse

from repro_torch.data.synthetic import pseudo_mnist_batch
from repro_torch.device import resolve_device
from repro_torch.launch.paper_loops import recall_at, train_classifier
from repro_torch.models import papernets as PN

VARIANTS = (("continuous tanh", 0, 0),
            ("tanhD(32)", 32, 0),
            ("tanh, |W|=1000", 0, 1000),
            ("tanhD(32) + |W|=1000", 32, 1000),
            ("tanhD(32) + |W|=100", 32, 100))


def apply_fn(p, x, act_levels, gen):
    return PN.mlp_apply(p, x, "tanh", act_levels)


def accuracy_table(steps=300, batch=64, cluster_every=75, hidden=(32, 32),
                   device=None) -> dict:
    """Each variant trained by ``train_classifier`` and scored by top-1
    ``recall_at``; prints the table, returns {label: accuracy}."""
    dev = resolve_device(device)

    def init(gen):
        return PN.mlp_init(gen, 784, list(hidden), 10, device=dev)

    def data(s):
        return pseudo_mnist_batch(s, batch, device=dev)

    print(f"{'variant':28s} accuracy")
    table = {}
    for label, levels, nw in VARIANTS:
        params, _, _ = train_classifier(init, apply_fn, data, steps=steps,
                                        act_levels=levels, n_weights=nw,
                                        cluster_every=cluster_every,
                                        device=dev)
        table[label] = recall_at(apply_fn, data, params, levels)[1]
        print(f"{label:28s} {table[label]:.4f}")
    return table


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run; unset = the GPU (fails without one)")
    return accuracy_table(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
