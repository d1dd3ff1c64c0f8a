"""The port's synthetic token pipeline (``repro_torch.data.tokens``).

Its bits are its own (a CPU ``torch.Generator`` seeded from (seed, step,
host); the reference draws with ``jax.random.categorical``, ROADMAP A8),
so it is held to the reference's contract, not its tokens: a batch is a
pure function of (seed, step, host); the pipeline's cursor round-trips
through ``state_dict``; a rescale re-derives only the host; the targets
are the tokens shifted by one; and the marginal is the reference's
p(r) = (1 / (r + 10)) / Z. The marginal is checked by Pearson's
chi-square over the 256 ranks of 200 000 draws against the 99.9%
quantile of chi-square with 255 degrees of freedom (a fixed seed: the
test is deterministic; a wrong marginal, such as uniform or 1 / (r + 1),
lands orders of magnitude above it, which the test also shows).
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.data.tokens import (TokenPipeline, synthetic_token_batch,
                                     zipf_probabilities)

V = 256


def test_a_batch_is_a_function_of_seed_step_and_host():
    a = synthetic_token_batch(0, 3, 4, 16, V, host=1, device="cpu")
    b = synthetic_token_batch(0, 3, 4, 16, V, host=1, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    for other in (dict(seed=1, step=3, host=1), dict(seed=0, step=4, host=1),
                  dict(seed=0, step=3, host=0)):
        c = synthetic_token_batch(other["seed"], other["step"], 4, 16, V,
                                  host=other["host"], device="cpu")
        assert not torch.equal(a["tokens"], c["tokens"]), other
    # num_hosts is carried and does not enter the draw, as in the reference
    d = synthetic_token_batch(0, 3, 4, 16, V, host=1, num_hosts=8,
                              device="cpu")
    assert torch.equal(a["tokens"], d["tokens"])


def test_shapes_types_and_the_shift():
    b = synthetic_token_batch(5, 0, 3, 10, V, device="cpu")
    assert b["tokens"].shape == b["targets"].shape == (3, 10)
    assert b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < V


def test_the_pipeline_steps_and_round_trips_its_state():
    p = TokenPipeline(seed=2, batch=2, seq_len=8, vocab_size=V, device="cpu")
    first = [p.next()["tokens"] for _ in range(3)]
    assert p.step == 3
    state = p.state_dict()
    assert state == {"seed": 2, "step": 3}
    nxt = p.next()["tokens"]
    q = TokenPipeline(seed=2, batch=2, seq_len=8, vocab_size=V, device="cpu")
    q.load_state_dict(state)
    assert torch.equal(q.next()["tokens"], nxt)
    assert torch.equal(first[1], synthetic_token_batch(
        2, 1, 2, 8, V, device="cpu")["tokens"])
    with pytest.raises(ValueError, match="seed"):
        TokenPipeline(seed=3, batch=2, seq_len=8, vocab_size=V,
                      device="cpu").load_state_dict(state)


def test_rescale_rederives_the_host_only():
    p = TokenPipeline(seed=0, batch=2, seq_len=8, vocab_size=V, step=5,
                      device="cpu")
    r = p.rescale(new_host=3, new_num_hosts=4)
    assert (r.host, r.num_hosts, r.step, r.seed) == (3, 4, 5, 0)
    assert (p.host, p.num_hosts) == (0, 1)
    assert dataclasses.replace(p, host=3, num_hosts=4) == r
    assert torch.equal(r.next()["tokens"], synthetic_token_batch(
        0, 5, 2, 8, V, host=3, num_hosts=4, device="cpu")["tokens"])


def _chi_square(tokens, probs):
    counts = np.bincount(tokens.flatten().numpy(), minlength=len(probs))
    expected = probs.numpy() * tokens.numel()
    return float(((counts - expected) ** 2 / expected).sum())


def test_the_marginal_is_the_references():
    probs = zipf_probabilities(V)
    w = 1.0 / (np.arange(V) + 10.0)
    np.testing.assert_allclose(probs.numpy(), w / w.sum(), rtol=1e-15)
    toks = synthetic_token_batch(0, 0, 200, 999, V, device="cpu")["tokens"]
    limit = stats.chi2.ppf(0.999, V - 1)
    assert _chi_square(toks, probs) < limit
    # wrong marginals are far outside
    uniform = torch.full((V,), 1.0 / V, dtype=torch.float64)
    steeper = 1.0 / (torch.arange(V, dtype=torch.float64) + 1.0)
    assert _chi_square(toks, uniform) > 10 * limit
    assert _chi_square(toks, steeper / steeper.sum()) > 10 * limit


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_token_batch(0, 0, 1, 4, V)
