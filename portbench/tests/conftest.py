"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
a second, and the look for a card, made inside a fixture."""

import copy

import pytest

from portbench.harness import env, registry

#: the tiny sizes: the surrogate at 0.6% (120,001 ratings, 831 users x
#: 160 items), rank 8, 3 iterations
TINY_DATASET = {"generator": "ml20m_surrogate", "scale": 0.006, "seed": 0,
                "n_users": 831, "n_items": 160}


def tiny(cell: registry.Cell) -> registry.Cell:
    cell.config = copy.deepcopy(cell.config)
    cell.config["dataset"] = dict(TINY_DATASET)
    cell.config["algorithm"]["rank"] = 8
    cell.config["algorithm"]["numIterations"] = 3
    return cell


@pytest.fixture(scope="session")
def bench():
    env.set_cache_env()
    return registry.load_benchmark()


@pytest.fixture
def tiny_cell(bench):
    """``tiny_cell(name)``: the named cell at the tiny sizes."""
    return lambda name: tiny(registry.Cell(bench, name))


@pytest.fixture(scope="session")
def run_module():
    return registry.load_module(registry.BENCH / "run.py", "portbench_run")


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env.set_cache_env()
