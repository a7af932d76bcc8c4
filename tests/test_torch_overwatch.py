"""The port's rank-aware logging and process-group start-up
(``emmax_torch.overwatch``, ``emmax_torch.parallel.distributed``) in the
six cases of ``tests/test_overwatch_distributed.py``, plus the card
start that must not fall back to gloo. Rank and world come from
``torch.distributed`` here; the tests stand in for a rank by patching
``_dist_rank_world`` as JAX's patch ``_jax_rank_world``."""

import logging

import pytest
import torch

from emmax_torch.overwatch import Overwatch, initialize_overwatch
from emmax_torch.parallel.distributed import barrier, initialize_distributed

GROUP_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID")


@pytest.fixture
def no_group_env(monkeypatch):
    for name in GROUP_VARS:
        monkeypatch.delenv(name, raising=False)


def test_initialize_returns_overwatch_with_rank_context():
    ow = initialize_overwatch("emmax_torch_test")
    assert isinstance(ow, Overwatch)
    assert ow.rank() == 0 and ow.world_size() == 1 and ow.is_rank_zero()


def test_rank_zero_only_runs_on_rank_zero_and_gates_elsewhere(monkeypatch):
    ow = initialize_overwatch("emmax_torch_test")
    calls = []

    @ow.rank_zero_only
    def record(x):
        calls.append(x)
        return x * 2

    assert record(3) == 6 and calls == [3]
    monkeypatch.setattr("emmax_torch.overwatch._dist_rank_world",
                        lambda: (1, 4))
    assert ow.rank() == 1 and ow.world_size() == 4
    assert record(5) is None
    assert calls == [3]


def test_log_messages_gated_by_rank_and_ctx_formatted(monkeypatch, caplog):
    ow = initialize_overwatch("emmax_torch_test_fmt")
    ow.logger.propagate = True
    with caplog.at_level(logging.INFO, logger="emmax_torch_test_fmt"):
        ow.info("top", ctx_level=0)
        ow.info("nested", ctx_level=2)
    assert "top" in caplog.text
    assert "    =>> nested" in caplog.text
    caplog.clear()
    monkeypatch.setattr("emmax_torch.overwatch._dist_rank_world",
                        lambda: (2, 4))
    with caplog.at_level(logging.INFO, logger="emmax_torch_test_fmt"):
        ow.info("rank0-only message")
        ow.info("everywhere", all_ranks=True)
    assert "rank0-only message" not in caplog.text
    assert "everywhere" in caplog.text


def test_initialize_distributed_single_process_noop(no_group_env):
    assert initialize_distributed() == 0
    assert not torch.distributed.is_initialized()


def test_barrier_without_a_group_completes(no_group_env):
    barrier("test")
    assert not torch.distributed.is_initialized()


def test_env_log_level_respected(monkeypatch):
    monkeypatch.setenv("EMMAX_LOG_LEVEL", "ERROR")
    ow = initialize_overwatch("emmax_torch_test_lvl")
    assert ow.logger.level == logging.ERROR


def test_card_start_raises_without_a_card(no_group_env, monkeypatch):
    """A "cuda" group without a card raises (it never starts on gloo); a
    group asked for without an address or a count raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2, device_type="cpu")
    assert not torch.distributed.is_initialized()
