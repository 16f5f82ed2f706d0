"""The port's examples (repro_torch.examples) run as programs on the CPU
(``--device cpu``), each to the success line its reference counterpart's
test checks (tests/test_examples.py); the text analysis also reads a
checkpoint the JAX package wrote, and ``train_lm`` (at a few small steps)
ends in the text analysis of its trained table.  The self-test's LM check
takes its train step.  Without ``--device cpu`` every example
asks for the card, and on a machine without one it fails instead of
carrying on on the CPU.
"""
import os
import subprocess
import sys

import pytest

import jax

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path, timeout=300):
    env = {"PYTHONPATH": os.path.join(REPO, "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path),
           "REPRO_TORCH_TUNE_CACHE": str(tmp_path / "tune.json")}
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{args[0]}"] + args[1:],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def _ok(r, line):
    assert r.returncode == 0, r.stderr[-2000:]
    assert line in r.stdout, r.stdout[-2000:]


def test_quickstart(tmp_path):
    r = _run(["quickstart", "--device", "cpu"], tmp_path)
    _ok(r, "all four methods agree")
    _ok(r, "knn restriction: exact at k=n-1")


def test_pald_knn_clusters_small(tmp_path):
    r = _run(["pald_knn_clusters", "--n", "2000", "--device", "cpu"],
             tmp_path)
    _ok(r, "no strong tie ever crosses communities")


def test_pald_knn_clusters_mesh(tmp_path):
    """The sharded branch: a local world of two spawned ranks."""
    r = _run(["pald_knn_clusters", "--n", "2000", "--mesh", "2",
              "--device", "cpu"], tmp_path)
    _ok(r, "mesh-sharded select->cohere (ring, mesh (2,)")
    _ok(r, "no strong tie ever crosses communities")


def test_pald_text_analysis_small(tmp_path):
    r = _run(["pald_text_analysis", "--max-tokens", "384", "--device", "cpu"],
             tmp_path)
    _ok(r, "strong ties")
    _ok(r, "[pald-text] n=384 embedding_dim=64")


def test_pald_text_analysis_reads_a_reference_checkpoint(tmp_path):
    """``--ckpt`` on a checkpoint of the JAX package's reduced gemma2-2b
    (token-embedding table 256 x 64): the newest complete step's table."""
    jcfg = jreduced(jconfigs.get("gemma2-2b"))
    jp = jax.jit(lambda k: JModel(jcfg).init(k)[0])(jax.random.PRNGKey(0))
    d = tmp_path / "ckpt"
    jck.save(str(d), 3, jp)
    os.makedirs(d / "step_00000009.tmp")           # incomplete: ignored
    r = _run(["pald_text_analysis", "--ckpt", str(d), "--max-tokens", "384",
              "--device", "cpu"], tmp_path)
    _ok(r, "[pald-text] n=256 embedding_dim=64")
    _ok(r, "strong ties")


def test_serve_lm_smoke(tmp_path):
    r = _run(["serve_lm", "--arch", "llama3.2-3b", "--batch", "2",
              "--prompt-len", "8", "--gen", "4", "--device", "cpu"], tmp_path)
    _ok(r, "[serve]")
    _ok(r, "3 decode steps")


def test_train_lm_small(tmp_path):
    """Training through the launcher, its final checkpoint, then the text
    analysis of the trained embedding table."""
    r = _run(["train_lm", "--steps", "4", "--batch", "2", "--seq", "32",
              "--max-tokens", "256", "--ckpt-dir", str(tmp_path / "ck"),
              "--device", "cpu"], tmp_path)
    _ok(r, "[train_lm] llama-100m: 63.6M params")
    _ok(r, "  step     3 loss")
    _ok(r, "[pald-text] n=256 embedding_dim=512")
    _ok(r, "strong ties")


def test_selftest_lm_cycle_takes_a_train_step():
    """The self-test's LM check: a train step of reduced gemma2-2b, then
    prefill and decode on the trained parameters."""
    from repro_torch.launch import selftest

    selftest._lm_cycle("cpu")


@pytest.mark.parametrize("example", ["quickstart", "pald_knn_clusters",
                                     "pald_text_analysis", "serve_lm",
                                     "train_lm"])
def test_examples_default_to_the_card(example, tmp_path):
    """Without --device cpu an example asks for the card; with no GPU it
    fails (on a machine with one it runs there)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    r = _run([example, "--n", "100"] if example == "pald_knn_clusters"
             else [example], tmp_path)
    assert r.returncode != 0
    assert "CUDA" in r.stderr + r.stdout, (r.stderr + r.stdout)[-2000:]
