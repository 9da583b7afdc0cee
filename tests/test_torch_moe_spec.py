"""Speculative decoding and the numerics probes of the ``moe`` family
against the JAX package's engine run live in this process, on the reduced
qwen3-moe-30b-a3b compressed as the launcher's ``--compress`` does it
(``test_torch_moe_serve.py`` has the model, the forward recorder and the
other serving paths):

* n-gram speculative rounds on every backend and a lut model draft,
  contiguous and paged: tokens, every forward's inputs (the verify rows of
  free and retired slots included) and ``SpecStats`` equal;
* ``probes=True``: tokens equal with probes off, counters equal to the
  reference's (KV errors within the sentinel slack), and at ``act_levels``
  32 (the reference under ``jax.disable_jit``, whose rounding is the
  port's) saturation counted on the experts' (E, C, f) buffers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving import SpecConfig  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from test_torch_moe import reference_moe_model  # noqa: E402
from test_torch_moe_serve import (BACKENDS, PROMPTS, STOPS,  # noqa: E402
                                  _engines, _pool_state, both)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def qmoe():
    return reference_moe_model()


# --- speculative rounds ----------------------------------------------------------

SPEC = [(be, "ngram", paged) for be in BACKENDS for paged in (False, True)] \
    + [("codebook", "model", False), ("codebook", "model", True)]


@pytest.mark.parametrize("backend,draft,paged", SPEC,
                         ids=[f"{b}-{d}-{'paged' if p else 'contig'}"
                              for b, d, p in SPEC])
def test_spec_equal_reference(qmoe, backend, draft, paged, monkeypatch):
    kw = dict(k=3, draft=draft)
    if draft == "model":
        jkw = dict(kw, draft_params=qmoe.params["index"],
                   draft_backend="lut")
        tkw = dict(kw, draft_params=qmoe.tparams["index"],
                   draft_backend="lut")
    else:
        jkw = tkw = kw
    ekw = dict(max_len=48, max_batch=2, paged=paged, page_size=8)
    which = "dense" if backend == "dense" else "index"
    je = qmoe.Engine(qmoe.model, qmoe.params[which], backend=backend,
                     spec=qmoe.Spec(**jkw), **ekw)
    te = TEngine(qmoe.tmodel, qmoe.tparams[which], backend=backend,
                 spec=SpecConfig(**tkw), device="cpu", **ekw)
    want, got = both(qmoe, lambda: [je.serve(PROMPTS, STOPS),
                                    je.serve(PROMPTS[:3], 5)],
                     lambda: [te.serve(PROMPTS, STOPS),
                              te.serve(PROMPTS[:3], 5)], monkeypatch)
    assert got == want
    assert dataclasses.asdict(te.spec_stats) \
        == dataclasses.asdict(je.spec_stats)
    if paged:
        assert _pool_state(te.pool) == _pool_state(je.pool)


# --- numerics probes ---------------------------------------------------------------

def _check_numerics(got: dict, want: dict) -> None:
    from repro_torch.serving.probes import golden_entry, sentinel_check
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.startswith("kv_err"):
            assert got[k] == v, k
    np.testing.assert_allclose(got["kv_err_max"], want["kv_err_max"],
                               rtol=0, atol=1e-4)
    assert sentinel_check(got, golden_entry(want)) == []


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged_int8"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_probes_equal_reference(qmoe, backend, paged):
    kw = dict(max_len=48, max_batch=2)
    if paged:
        kw.update(paged=True, page_size=8, kv_dtype="int8")
    je, te = _engines(qmoe, backend, probes=True, **kw)
    _, off = _engines(qmoe, backend, **kw)
    got = te.serve(PROMPTS, STOPS)
    assert got == je.serve(PROMPTS, STOPS) == off.serve(PROMPTS, STOPS)
    _check_numerics(te.numerics(), je.numerics())


def test_probes_count_expert_saturation_at_act_levels_32(monkeypatch):
    """At ``act_levels`` 32 the experts' activation is the quantized relu6
    on the whole (E, C, f) buffer, empty slots included: ``act_sat`` and
    ``act_total`` equal the reference's (run eagerly, where its rounding
    is the port's)."""
    m = reference_moe_model(act_levels=32)
    je, te = _engines(m, "codebook", max_len=48, max_batch=2, probes=True)
    want, got = both(m, lambda: je.serve(PROMPTS[:3], 4),
                     lambda: te.serve(PROMPTS[:3], 4), monkeypatch,
                     eager=True)
    assert got == want
    tn = te.numerics()
    with m.jax.disable_jit():
        jn = je.numerics()
    _check_numerics(tn, jn)
    assert sum(tn["act_sat"]) > 0
