"""The port's serving launcher (``repro_torch/launch/serve.py``) against the
JAX package's ``repro.launch.serve``, both run in this process on the
reduced qwen3 with the reference's ``PRNGKey(0)`` weights (the port's
``init_params`` is replaced by them through the bridge):

* the argv of every CPU smoke run of the reference's docstring but
  ``--tp``, with smaller ``--requests``/``--max-new``, and ``--uniform``,
  ``--spec-draft model --compress``, ``--probes --numerics-out``,
  ``--server --metrics-out --trace-out`` and ``--traffic replay
  --trace-file``, and two runs of the reduced qwen3-moe-30b-a3b with its
  own weights (lut on int8 pages; ``--server``): stdout equal line for
  line once the wall-clock figures
  (seconds, tok/s, ms/request) are masked — ``[memory]``, tokens, ``[kv]``,
  ``[spec]``, the virtual TTFT/TPOT/SLO report, admission order, ``[fleet]``
  lines and the event digest.  The KV error of the numerics lines is
  masked (float K/V round differently, by about 1e-6): the numerics JSON
  holds every other field exactly and the KV errors within
  ``serving/probes.py``'s sentinel slack.  The metrics snapshot equals the
  reference's without the kernels section, the Perfetto trace exactly;
* every refusal of the reference (``ap.error`` and its ``SystemExit``s)
  with the same exit code and message, ``--tp 2`` with probes or the
  server and speculative decoding among them; the encoder-decoder and
  vision-language families
  (whisper-small, qwen2-vl-7b) and the recurrent families (rwkv6-7b,
  zamba2-2.7b) built and refused by ``ServeEngine`` with the reference's
  message;
* the flags, defaults, choices and help of the reference's parser;
* sampling (T = 0.8) held to the port itself: one seed, one output, and
  ``--top-k 1`` equals greedy;
* no module of the port but ``launch/`` reads the wall clock.
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as TS  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDUCED = ["--arch", "qwen3-1.7b", "--reduced"]

# name -> argv after REDUCED; {dir} is each side's own output directory
CASES = {
    "compress": "--compress --requests 6 --max-batch 4 --max-new 8",
    "paged_int8": "--paged --kv-dtype int8 --requests 6 --max-batch 4 "
                  "--max-new 8",
    "spec_ngram": "--spec-draft ngram --spec-k 4 --requests 6 --max-new 12",
    "server": "--server --traffic poisson --rate 40 --requests 10 --paged "
              "--priority-levels 2 --slo-ttft 0.3",
    "fleet_drain_scale": "--server --replicas 3 --paged --rate 80 "
                         "--requests 12 --drain-at 0.4:r0 --scale-at 0.6:r3",
    "fleet_migrate": "--server --replicas 4 --paged --rate 120 --requests 16 "
                     "--migrate-on-drain --shared-prefix-tier --shed-policy "
                     "slo --drain-at 0.3:r0",
    "uniform": "--compress --backend codebook --uniform --requests 4 "
               "--max-new 8",
    "spec_model": "--spec-draft model --compress --backend codebook "
                  "--requests 4 --max-batch 2 --max-new 8",
    "probes": "--compress --backend lut --paged --kv-dtype int8 --probes "
              "--numerics-out {dir}/numerics.json --requests 4 --max-new 8",
    "server_telemetry": "--server --paged --requests 8 --compress --backend "
                        "codebook --metrics-out {dir}/metrics.json "
                        "--trace-out {dir}/trace.json",
    "replay": "--server --traffic replay --trace-file {trace} --paged "
              "--page-size 8 --max-batch 2 --quantum 2",
    "moe_lut_paged_int8": "--compress --backend lut --paged --kv-dtype int8 "
                          "--requests 6 --max-batch 4 --max-new 8",
    "moe_server": "--server --paged --kv-dtype int8 --requests 8 --compress "
                  "--backend codebook",
}
# the --arch of a case when it is not qwen3-1.7b
ARCH = {"moe_lut_paged_int8": "qwen3-moe-30b-a3b",
        "moe_server": "qwen3-moe-30b-a3b"}

_WALL = re.compile(r"in \d+\.\d+s|\d+\.\d+ tok/s|\d+\.\d+ ms/request")
_KV_ERR = re.compile(r"kv err max \S+|kv round-trip err \S+")


def _masked(out: str, out_dir: str) -> list:
    """stdout lines with the wall-clock figures, the KV errors and the
    output directory masked, and the kernels summary line (each package
    counts its own kernels) dropped."""
    lines = []
    if out_dir:
        out = out.replace(out_dir, "<dir>")
    for ln in out.splitlines():
        if ln.startswith("[telemetry] kernels:"):
            continue
        lines.append(_KV_ERR.sub("<kv>", _WALL.sub("<wall>", ln)))
    return lines


def _reference_weights(arch):
    """A reduced registry model's weights as the reference's launcher draws
    them, as numpy."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.models.model_zoo import build

    params = build(C.get(arch).reduced()).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ref_params():
    """The reduced qwen3's weights as the reference's launcher draws them,
    as numpy."""
    return _reference_weights("qwen3-1.7b")


@pytest.fixture(scope="module")
def case_params(ref_params):
    """The reference's weights of a case's ``--arch``."""
    cache = {"qwen3-1.7b": ref_params}

    def get(name):
        arch = ARCH.get(name, "qwen3-1.7b")
        if arch not in cache:
            cache[arch] = _reference_weights(arch)
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def trace_file(tmp_path_factory):
    from repro_torch.serving import poisson_trace, save_trace
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    save_trace(path, poisson_trace(3, 8, rate=60.0, vocab=512,
                                   plen=(2, 12), max_new=(2, 10),
                                   priorities=(0, 1)))
    return path


def _argv(name, out_dir, trace):
    return (["--arch", ARCH.get(name, "qwen3-1.7b"), "--reduced"]
            + CASES[name].format(dir=out_dir, trace=trace).split())


def run_reference(argv) -> str:
    """``repro.launch.serve.main`` on ``argv`` through ``sys.argv``: its
    stdout."""
    from repro.launch import serve as RS
    saved, buf = sys.argv, io.StringIO()
    sys.argv = ["serve.py"] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            RS.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def run_port(argv, monkeypatch, params=None) -> str:
    """The port's ``main`` on ``argv`` on the CPU, with the reference's
    weights when ``params`` is given: its stdout."""
    if params is not None:
        from repro_torch.bridge import from_jax_params
        monkeypatch.setattr(TS, "init_params",
                            lambda model, device: from_jax_params(params,
                                                                  device))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TS.main(list(argv) + ["--device", "cpu"])
    return buf.getvalue()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, trace_file):
    """Each case's reference stdout, run once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            d = str(tmp_path_factory.mktemp(f"ref_{name}"))
            cache[name] = (d, run_reference(_argv(name, d, trace_file)))
        return cache[name]
    return get


def _check_numerics(got: dict, want: dict) -> None:
    from repro_torch.serving.probes import golden_entry, sentinel_check
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.startswith("kv_err"):
            assert got[k] == v, k
    np.testing.assert_allclose(got["kv_err_max"], want["kv_err_max"],
                               rtol=0, atol=1e-4)
    assert sentinel_check(got, golden_entry(want)) == []
    assert sentinel_check(want, golden_entry(got)) == []


@pytest.mark.parametrize("name", list(CASES))
def test_launcher_prints_the_reference_lines(name, reference, case_params,
                                             trace_file, tmp_path,
                                             monkeypatch):
    ref_dir, want = reference(name)
    port_dir = str(tmp_path)
    got = run_port(_argv(name, port_dir, trace_file), monkeypatch,
                   case_params(name))
    assert _masked(got, port_dir) == _masked(want, ref_dir)
    tags = {ln.split(" ", 1)[0] for ln in got.splitlines()}
    assert "sample:" in tags
    if "--compress" in CASES[name]:
        assert "[memory]" in tags
    if name == "probes":
        with open(f"{port_dir}/numerics.json") as f, \
                open(f"{ref_dir}/numerics.json") as g:
            _check_numerics(json.load(f), json.load(g))
    if name == "server_telemetry":
        snaps = []
        for d in (port_dir, ref_dir):
            with open(f"{d}/metrics.json") as f:
                s = json.load(f)
            s.pop("kernels", None)
            snaps.append(s)
        assert snaps[0] == snaps[1]
        with open(f"{port_dir}/trace.json") as f, \
                open(f"{ref_dir}/trace.json") as g:
            assert json.load(f) == json.load(g)


# --- refusals ----------------------------------------------------------------

REFUSALS = [
    "--paged --uniform",
    "--spec-draft ngram --uniform",
    "--spec-draft model",
    "--server --uniform",
    "--server --spec-draft ngram",
    "--metrics-out m.json",
    "--trace-out t.json",
    "--numerics-out n.json",
    "--replicas 2",
    "--drain-at 0.5:r0",
    "--shed-policy slo",
    "--server --replicas 0",
    "--server --shared-prefix-tier",
    "--server --shed-threshold 1.5",
    "--probes --spec-draft ngram",
    "--tp 2 --paged --page-size 15",
    "--backend codebook",
    "--backend lut --requests 2",
    "--backend foo",
    "--server --traffic replay",
    "--server --requests 0",
    "--server --requests 2 --max-new 2 --drain-at 0.3",
]


def _refusal(call):
    """(exit code, message) of a call that must exit: ``ap.error``'s
    message after ``error: ``, or the ``SystemExit``'s own."""
    err = io.StringIO()
    with pytest.raises(SystemExit) as ei, contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        call()
    code = ei.value.code
    if isinstance(code, str):
        return 1, code
    return code, err.getvalue().rsplit("error: ", 1)[-1].strip()


@pytest.mark.parametrize("flags", REFUSALS)
def test_refusals_match_reference(flags, ref_params, monkeypatch):
    argv = REDUCED + flags.split()
    want = _refusal(lambda: run_reference(argv))
    got = _refusal(lambda: run_port(argv, monkeypatch, ref_params))
    assert got == want
    assert want[0] in (1, 2) and want[1]


def test_tp_refused_naming_the_tp_slice(ref_params, monkeypatch):
    """``--tp`` serves everything the reference serves under a mesh, the
    request server and the probes included; with ``--tp 2`` the port
    refuses what the reference refuses, with its exit code and message:
    probes and the request server with speculative decoding."""
    for flags in ("--tp 2 --probes --spec-draft ngram",
                  "--tp 2 --server --paged --spec-draft ngram"):
        argv = REDUCED + flags.split()
        want = _refusal(lambda: run_reference(argv))
        got = _refusal(lambda: run_port(argv, monkeypatch, ref_params))
        assert got == want
        assert want[0] == 2 and "spec" in want[1]


def test_non_dense_arch_refused_by_build():
    """``build`` refuses no LM family now: the encoder-decoder
    (whisper-small's ``audio``) and the vision-language family
    (qwen2-vl-7b's ``vlm``) are built, and ``ServeEngine`` refuses them
    with the reference's exception and text, as the reference's launcher
    does: it serves the ``dense`` and ``moe`` families (the ``moe_*``
    cases above), and the recurrent families are refused the same way
    (below)."""
    for arch in ("whisper-small", "qwen2-vl-7b"):
        argv = ["--arch", arch, "--reduced"]
        with pytest.raises(NotImplementedError) as want, \
                contextlib.redirect_stdout(io.StringIO()):
            run_reference(argv)
        with pytest.raises(NotImplementedError) as got, \
                contextlib.redirect_stdout(io.StringIO()):
            TS.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
        assert str(want.value).startswith(
            "ServeEngine serves KV-cache token LMs")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_recurrent_arch_refused_by_engine(arch):
    """The recurrent families are built, and ``ServeEngine`` refuses them
    with the reference's exception and text, as the reference's launcher
    does: it serves KV-cache token LMs."""
    argv = ["--arch", arch, "--reduced"]
    with pytest.raises(NotImplementedError) as want, \
            contextlib.redirect_stdout(io.StringIO()):
        run_reference(argv)
    with pytest.raises(NotImplementedError) as got, \
            contextlib.redirect_stdout(io.StringIO()):
        TS.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert str(want.value).startswith("ServeEngine serves KV-cache token LMs")


def _actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.help,
                     a.type, a.nargs, a.metavar, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_reference(monkeypatch):
    """Every flag of the reference's parser with its default, choices,
    type and help; the port adds ``--device`` only."""
    pytest.importorskip("jax")
    from repro.launch import serve as RS

    seen = {}

    def capture(self, *a, **kw):
        seen["parser"] = self
        raise KeyboardInterrupt

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(KeyboardInterrupt):
        RS.main()
    monkeypatch.undo()
    want = _actions(seen["parser"])
    got = _actions(TS._parser())
    assert got.pop("device")[:2] == (("--device",), None)
    assert got == want


# --- sampling: the port against itself ---------------------------------------

def test_sampling_is_seeded_and_top1_is_greedy():
    base = REDUCED + ["--compress", "--backend", "codebook", "--requests",
                      "4", "--max-new", "6"]
    sample = base + ["--temperature", "0.8", "--top-k", "4", "--top-p",
                     "0.9"]
    runs = [run_port(sample, None) for _ in range(2)]
    assert _masked(runs[0], "") == _masked(runs[1], "")
    greedy = _masked(run_port(base, None), "")
    top1 = _masked(run_port(base + ["--temperature", "0.8", "--top-k", "1"],
                            None), "")
    assert top1 == greedy
    assert greedy[-1].startswith("sample:")
    assert _masked(runs[0], "")[-1] != greedy[-1]     # T = 0.8 did sample


# --- the wall clock ----------------------------------------------------------

def test_only_launch_reads_the_wall_clock():
    pat = re.compile(r"\btime\.(time|perf_counter|monotonic|process_time)"
                     r"(_ns)?\(|\bdatetime\.now\(")
    pkg = os.path.join(ROOT, "src", "repro_torch")
    readers = set()
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    if pat.search(f.read()):
                        readers.add(os.path.relpath(path, pkg))
    assert readers == {os.path.join("launch", "serve.py"),
                       os.path.join("launch", "train.py")}
