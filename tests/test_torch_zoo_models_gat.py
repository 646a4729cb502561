"""The GAT networks and DGCNN of grl_torch against grl_tpu's, on the CPU
in float32: the checks of ``tests/test_torch_zoo_models.py`` (eval and
train-mode logits, batch_stats, gradients, two Adam steps) on ``GATV2``
(``use_v2`` true and false) and ``DGCNN``, in a file of their own so that
each file stays near 90 s.
"""
from __future__ import annotations

import pytest
import torch

from test_torch_zoo_models import (
    check_eval_logits,
    check_train_logits_stats_and_gradients,
    check_two_adam_steps,
    make_net,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["DGCNN", "GATV2", "GATV2-v1"])
def net(request):
    return make_net(request.param)


def test_eval_logits_match_grl_tpu(net):
    check_eval_logits(net)


def test_train_logits_stats_and_gradients_match_grl_tpu(net):
    check_train_logits_stats_and_gradients(net)


def test_two_adam_steps_match_grl_tpu(net, tmp_path):
    check_two_adam_steps(net, tmp_path)
