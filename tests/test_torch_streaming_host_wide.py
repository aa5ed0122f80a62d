"""Port parity: filter_kmers_streaming's host merge against the JAX package
at K = 63 and 64, four limbs (the cases of test_torch_streaming_host.py)."""

import pytest

from test_torch_streaming_host import DATA_REDUCE, _host_case


@pytest.mark.parametrize("data_reduce", DATA_REDUCE)
@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [63, 64])
def test_host_merge_matches_jax(rng, k, stranded, data_reduce):
    _host_case(rng, k, stranded, data_reduce)
