"""The port's synthetic token pipeline (repro_torch.data.pipeline) against
the JAX package's (repro.data.pipeline), on the CPU.

Batches are bitwise the reference's for several (vocab, seq, batch, seed,
step); then the counterparts of tests/test_data.py on the port
(determinism, steps and seeds differ, labels the tokens shifted by one,
the vocabulary's bounds).  Without ``device="cpu"`` the pipeline asks for
the card.
"""
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro_torch.data.pipeline import SyntheticTokens


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (100, 16, 4, 3, 7), (256000, 128, 8, 0, 0), (37, 64, 8, 5, 11),
    (32000, 33, 3, 2**20 + 1, 123456)])
def test_batches_are_the_references(vocab, seq, batch, seed, step):
    want = JSyntheticTokens(vocab, seq, batch, seed=seed).batch_at(step)
    got = SyntheticTokens(vocab, seq, batch, seed=seed,
                          device="cpu").batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_deterministic_across_instances():
    a = SyntheticTokens(100, 16, 4, seed=3, device="cpu").batch_at(7)
    b = SyntheticTokens(100, 16, 4, seed=3, device="cpu").batch_at(7)
    assert torch.equal(a["tokens"], b["tokens"])


def test_different_steps_and_seeds_differ():
    d = SyntheticTokens(100, 16, 4, seed=3, device="cpu")
    assert not torch.equal(d.batch_at(0)["tokens"], d.batch_at(1)["tokens"])
    other = SyntheticTokens(100, 16, 4, seed=4, device="cpu")
    assert not torch.equal(d.batch_at(0)["tokens"],
                           other.batch_at(0)["tokens"])


def test_labels_are_shifted_tokens():
    d = SyntheticTokens(100, 16, 4, seed=3, device="cpu")
    b = d.batch_at(0)
    assert b["tokens"].shape == (4, 16) and b["labels"].shape == (4, 16)
    full = d._host_batch(0, 0, 4)
    np.testing.assert_array_equal(b["tokens"].numpy(), full[:, :-1])
    np.testing.assert_array_equal(b["labels"].numpy(), full[:, 1:])
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_vocab_bounds():
    t = SyntheticTokens(37, 64, 8, seed=5, device="cpu").batch_at(11)
    assert int(t["tokens"].min()) >= 0 and int(t["tokens"].max()) < 37


def test_iterates_the_steps():
    d = SyntheticTokens(50, 8, 2, seed=1, device="cpu")
    it = iter(d)
    for step in range(3):
        assert torch.equal(next(it)["tokens"], d.batch_at(step)["tokens"])


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokens(10, 4, 2)
