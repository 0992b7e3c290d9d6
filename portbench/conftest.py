"""Small shapes for the benchmark's tests on the CPU
(``python -m pytest portbench/tests``) of the configurations added after
``portbench/tests/conftest.py``'s ``SMALL``.

The tests parametrized over every cell of ``BENCHMARK.json``
(``test_portbench_reference``, ``_control``, ``_faults``) take each cell's
small shape from ``SMALL``; the session fixture below puts these in it
before the first test runs, so that a test file run alone finds them as
the whole directory does.
"""
import pytest

LATER = {
    # two B/C groups, two shared blocks on hybrid layers 1 and 3
    "zamba2_7b": dict(
        n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=32, d_ff=128,
        vocab=512, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
        adapter_rank=8, hybrid_layer_ids=[1, 3]),
}


@pytest.fixture(autouse=True, scope="session")
def later_small_shapes():
    from conftest import SMALL   # portbench/tests/conftest.py

    for name, shape in LATER.items():
        SMALL.setdefault(name, shape)
    yield
