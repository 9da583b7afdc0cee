"""The port's vision-language family (``vlm``: qwen2-vl-7b, M-RoPE) against
the JAX package's, computed live in this process (f32, seeded numpy
inputs, the reference's ``PRNGKey(0)`` weights carried across by
``bridge.from_jax_params``):

* ``rope`` with M-RoPE sections (16, 24, 24) at hd 128 and (4, 6, 6) at
  hd 32, for (3, B, L) and (B, L) positions, within 1e-6; four sections,
  whose ids the reference cuts at 2; with one position stream (or three
  equal ones) bit-equal to the rotary embedding every other path calls,
  kept here as it was before M-RoPE;
* the reduced qwen2-vl-7b (2 layers, sections (4, 6, 6), untied head): the
  prompt as embeddings with Qwen2-VL's position layout (text, a 1 × 2 × 2
  patch grid, text), also without ``positions`` and with ``lengths``, on
  dense (the float weights), codebook and lut (compressed at |W| 256), at
  act_levels 0 and 32: ``forward``, ``prefill`` and 8 greedy decodes
  (looked up in ``embed``, one position stream from the prompt length, as
  the reference's) with tokens equal and logits within 1e-3, the cache's
  K/V planes of the reference's shapes and dtypes, lut's activation snaps
  held to the reference's with the ties counted
  (``families_rig.lock_snaps``);
* the refusals: training, the paged cache and the verify step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from families_rig import (  # noqa: E402
    BACKENDS, N_WEIGHTS, assert_cache_like, assert_runs_agree, inputs,
    lock_snaps,
    lut_specs, mrope_positions, reference_model, refusal, run_port,
    run_reference, with_levels)
from repro_torch.models import attention as TA  # noqa: E402

from repro_torch.kernels import dispatch as TD  # noqa: E402

torch.set_num_threads(2)

NAME = "qwen2-vl-7b"
N_NEW = 8


def rope_before_mrope(x, pos, theta=1e4):
    """The port's rotary embedding as it was before M-RoPE: one (B, L)
    position stream for every band."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32)
                             / hd))
    ang = pos.to(torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., ::2].to(torch.float32), x[..., 1::2].to(torch.float32)
    out = torch.stack([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


ROPE_CASES = {"hd128": ((16, 24, 24), 128), "hd32": ((4, 6, 6), 32),
              "four_sections": ((4, 4, 4, 4), 32),
              "short_sections": ((4, 6), 32)}


@pytest.mark.parametrize("streams", [3, 1])
@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_sections_match_reference(case, streams):
    """M-RoPE against the reference's ``rope(x, pos, theta, sections)``:
    (3, B, L) positions of the Qwen2-VL layout (the bands of each section
    driven by their own stream; a fourth section's bands by the third
    stream; bands past the sections by the last one), or one (B, L)
    stream."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import attention as JA
    sections, hd = ROPE_CASES[case]
    rng = np.random.default_rng(hd + len(sections))
    B, L = 2, 12
    x = rng.standard_normal((B, L, 3, hd)).astype(np.float32)
    pos = mrope_positions(B, 3, (1, 2, 3), L - 9)
    if streams == 1:
        pos = pos[1]
    want = JA.rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = TA.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_section_ids_follow_the_reference():
    """The stream of each band: ``jnp.repeat`` over the sections with
    ``total_repeat_length`` hd/2 (the last id repeated, or the ids cut),
    capped at 2."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    for sections in ((16, 24, 24), (4, 6, 6), (4, 4, 4, 4), (4, 6),
                     (10, 10, 10), ()):
        for n in (16, 64):
            if sections:
                want = jnp.minimum(jnp.repeat(
                    jnp.arange(len(sections)), jnp.asarray(sections),
                    total_repeat_length=n), 2)
            else:
                want = jnp.zeros((n,), jnp.int32)
            assert TA._section_ids(sections, n) == np.asarray(want).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_stream_is_the_rope_of_before(dtype):
    """With one (B, L) stream, or three equal ones, M-RoPE is bit-equal to
    the rotary embedding of every other path, whatever the sections."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 32)).astype(
        np.float32)).to(getattr(torch, dtype))
    pos = torch.from_numpy(rng.integers(0, 5000, (2, 9)))
    want = rope_before_mrope(x, pos, 1e6)
    assert torch.equal(TA.rope(x, pos, 1e6), want)
    assert torch.equal(TA.rope(x, pos, 1e6, (4, 6, 6)), want)
    assert torch.equal(TA.rope(x, pos.expand(3, 2, 9), 1e6, (4, 6, 6)), want)


# --- the reduced model ------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    pytest.importorskip("jax")
    ns = reference_model(NAME, n_weights=N_WEIGHTS)
    return {0: ns, 32: with_levels(ns, 32)}


BATCHES = {"mrope": dict(), "no_positions": dict(positions=False),
           "lengths": dict(lengths=[10, 7])}


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_reduced_vlm_matches_reference(backend, levels, models,
                                       monkeypatch):
    """Dense on the float weights, codebook and lut on the compressed
    tree, the untied head through the backend: the prompt as embeddings
    with the M-RoPE layout, without positions and with ``lengths``, 8
    greedy decodes each: tokens equal, forward, prefill and decode logits
    within 1e-3; the prefill cache's K/V planes of the reference's shapes
    and dtypes.  On lut every activation snap is held to the reference's
    level, and a level that differs must be a half-way tie
    (``lock_snaps``: one does, in the ``lengths`` batch at act_levels
    32)."""
    ns = models[levels]
    assert "lm_head" in ns.params and not ns.cfg.tie_embeddings
    jspec, tspec = lut_specs(ns)
    from repro.kernels import dispatch as JD
    snaps = lock_snaps(JD, TD, monkeypatch) if backend == "lut" else None
    jp = ns.params if backend == "dense" else None
    tp = ns.tparams if backend == "dense" else None
    for name, kw in BATCHES.items():
        batch = inputs(ns.cfg, 2, 10, 4, **kw)
        run = dict(forward=name != "lengths")
        want = run_reference(ns, batch, N_NEW, backend, jspec, jp, **run)
        got = run_port(ns, batch, N_NEW, backend, tspec, tp, **run)
        assert_runs_agree(got, want, what=f"{backend} {name}")
        assert_cache_like(got["cache"], want["cache"])
    assert snaps is None or (snaps["snaps"] and not snaps["pending"])


def test_positions_matter():
    """The M-RoPE layout moves the logits away from those of text
    positions 0..L−1 (which a missing ``positions`` gives)."""
    ns = reference_model(NAME)
    batch = {k: torch.from_numpy(v)
             for k, v in inputs(ns.cfg, 2, 10, 4).items()}
    a = ns.tmodel.forward(ns.tparams, batch)
    b = ns.tmodel.forward(ns.tparams, {k: v for k, v in batch.items()
                                       if k != "positions"})
    assert torch.equal(a[:, :2], b[:, :2])        # the leading text tokens
    assert float((a[:, 2:] - b[:, 2:]).abs().max()) > 1e-3


def test_refusals():
    """The family trains; what still refuses a gradient, as the
    reference defines none: the quantized activation's level index (the
    §4 engine's) of the first FFN input under the loss, and at act_levels
    32 the codebook backend's gated FFN launch (``codebook_swiglu``) in
    ``forward`` of the compressed tree whose codebooks require grad; the
    paged cache and the verify step refuse the family with the
    reference's text."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro_torch.kernels import dispatch as TD
    from repro_torch.models.model_zoo import build
    from train_rig import (first_ffn_input, index_form_with_grad,
                           refused_level_index)
    ns = reference_model(NAME)
    batch = inputs(ns.cfg, 2, 10, 2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    refused_level_index(first_ffn_input(ns.tmodel, ns.tparams, tb))
    quantized = build(ns.tmodel.cfg.replace(act_levels=32))
    with pytest.raises(RuntimeError,
                       match="codebook_swiglu has no gradient"):
        quantized.forward(index_form_with_grad(ns.tparams), tb,
                          TD.BackendSpec("codebook"))
    assert refusal(lambda: ns.tmodel.init_paged_cache(4, 8, device="cpu")) \
        == refusal(lambda: ns.model.init_paged_cache(4, 8))
    jcache = ns.model.init_cache(2, 8, dtype=jnp.float32)
    tcache = ns.tmodel.init_cache(2, 8, dtype=torch.float32, device="cpu")
    assert refusal(lambda: ns.tmodel.verify(ns.tparams, tb["tokens"],
                                            tcache)) \
        == refusal(lambda: ns.model.verify(ns.params,
                                           jnp.asarray(batch["tokens"]),
                                           jcache))
