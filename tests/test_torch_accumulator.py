"""The dense int32 accumulator's flush rule: the device histogram is
added into the host int64 histogram BEFORE any batch that could take it
past 2^31 - 1 windows, and a batch that could pass that alone is refused.
No JAX here (the JAX package's counters share the wrap, so the
expectation is the int64 count), so the file also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m slow tests/test_torch_accumulator.py
"""

import numpy as np
import pytest

import dna_kmeres_parallel_tpu_torch as port
from dna_kmeres_parallel_tpu_torch.models import engine


@pytest.mark.parametrize(
    "acc,batch,flush",
    [(0, 2**31 - 1, False), (2**31 - 2, 1, False), (2**31 - 1, 1, True),
     (2**30, 2**30 - 1, False), (2**30, 2**30, True), (7 * 2**28, 2**28, True),
     (1, 2**31 - 1, True), (0, 0, False)],
)
def test_flush_first_decides_before_the_batch(acc, batch, flush):
    # The accumulator is flushed before a batch that could take it past
    # 2^31 - 1 windows, whatever the batch size: a 2^28-window batch onto
    # 2^31 - 2^27 windows held wrapped the int32 counts when the flush was
    # tested after the add.
    assert engine.FLUSH_WINDOWS == 2**31 - 1
    assert engine.flush_first(acc, batch, 1 << 24) is flush


@pytest.mark.parametrize("batch", [2**31, 2**31 + 16, 2**40])
def test_flush_first_refuses_a_batch_past_int32(batch):
    with pytest.raises(ValueError, match=f"batch_bases={batch}"):
        engine.flush_first(0, batch, batch)


@pytest.mark.slow
def test_two_gigabase_homopolymer_counts_exactly():
    # 2^31 + 16 A's in 2^28-base batches: the int32 accumulator would wrap
    # at 2^31 (the JAX package's KmerEngine returns -2,147,483,632 here);
    # the flush before the eighth batch keeps the int64 count exact.
    n = 2**31 + 16
    flat = np.zeros(n, np.uint8)
    eng = engine.KmerEngine(port.KmerConfig(k=1, batch_bases=2**28, pack_input=False),
                            device="cpu")
    hist = eng.count_stream(flat, n, 1).hist
    assert hist.tolist() == [n, 0, 0, 0]
