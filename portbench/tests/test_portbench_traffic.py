"""Everything a run draws comes from ``--seed``: the same seed gives the
same sub-seeds, weights and corpus; another seed other ones."""

import numpy as np
import pytest
import torch

from portbench.harness import seeded


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_sub_seeds(seed):
    a, b = seeded.sub_seeds(seed), seeded.sub_seeds(seed)
    assert a == b and len(set(a.values())) == len(a)
    assert all(0 <= v < 2**63 for v in a.values())
    assert a != seeded.sub_seeds(seed + 1)


def test_weights_and_corpus():
    specs = [("a.weight", (8, 4, 3, 3)), ("a.bias", (8,)), ("n.weight", (4,))]
    w1 = seeded.make_weights(specs, 3, "cpu")
    w2 = seeded.make_weights(specs, 3, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert float(w1["a.weight"].std()) == pytest.approx(36 ** -0.5, rel=0.3)
    assert float(w1["n.weight"].mean()) == pytest.approx(1.0, abs=0.2)
    c1 = seeded.make_corpus(5, 4, 3, 11, "cpu")
    assert c1.dtype == np.uint8 and c1.shape == (5, 4, 4, 3)
    assert np.array_equal(c1, seeded.make_corpus(5, 4, 3, 11, "cpu"))
    assert not np.array_equal(c1, seeded.make_corpus(5, 4, 3, 12, "cpu"))
