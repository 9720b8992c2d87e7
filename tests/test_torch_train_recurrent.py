"""Port parity: LM training of the recurrent families (the hybrid
RecurrentGemma, RG-LRU with local attention; the ssm xLSTM, mLSTM and
sLSTM) at smoke widths, by the float32 rules of ``tests/test_torch_train.py``
(a file of its own so that ``--dist loadfile`` spreads the work): with the
score products in float32, loss and metrics rtol 1e-5, every gradient leaf
and, after 3 train steps from the same AdamW state, every parameter and
moment within 1e-4 of the leaf's largest magnitude. xLSTM has no score
product; the hybrid's local attention has one. Measured: gradients 3.3e-5
(xlstm-1.3b) of each leaf's maximum with its bfloat16 score products left
as they are, and 2.7e-4 at recurrentgemma-2b's local-attention wk.
"""
import pytest

import _torch_train as tr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with tr.torch_threads(1):
        yield


@pytest.mark.parametrize("name", ("recurrentgemma-2b", "xlstm-1.3b"))
def test_forward_train_and_steps_match_reference(name):
    tr.run_parity(name)
