"""Pin the hybrid autotuner's routing decisions (models.aln.
plan_device_share) for synthetic rate inputs.

The split policy decides how much of each chunk the device gets vs the
native host engine.  A kernel regression that tanks the device rate must
show up as the device being benched out — and, symmetrically, a healthy
device rate must keep the device loaded.  These are guard rails: kernel
work can't silently re-route to the host and fake a win.
"""

from nabwa_tpu.models.aln import plan_device_share


def plan(n=32768, batch=1024, dev=8_000.0, host=25_000.0, cores=4,
         lat=0.12):
    return plan_device_share(n, batch, dev, host, cores, lat)


def test_fast_device_takes_majority():
    # device clearly out-running the 4-core host: it must get the
    # majority share, in whole slices
    n_dev = plan(dev=100_000.0, host=25_000.0)
    assert n_dev >= 16384, n_dev
    assert n_dev % 1024 == 0
    assert n_dev < 32768          # host always keeps the remainder


def test_slow_device_is_benched():
    # device below ~1.1x one host core (25k/4 = 6.25k/core): driving it
    # displaces more host throughput than it adds -> bench it
    assert plan(dev=6_000.0, host=25_000.0) == 0


def test_marginal_device_gets_some_work():
    # device at ~8k vs 6.25k/core clears the opportunity bar and must
    # NOT be benched
    n_dev = plan(dev=8_000.0, host=25_000.0)
    assert n_dev > 0
    assert n_dev % 1024 == 0


def test_short_chunk_is_host_only():
    # 2k reads: the fixed device latency can't amortize inside the host
    # drain window -> all host
    assert plan(n=2048, dev=8_000.0, host=25_000.0) == 0


def test_latency_guard_sheds_slices():
    # with zero latency the proportional share stands; adding a fat
    # fixed latency can only shrink it
    free = plan(dev=50_000.0, host=25_000.0, lat=0.0)
    taxed = plan(dev=50_000.0, host=25_000.0, lat=1.0)
    assert taxed <= free


def test_device_share_never_exceeds_chunk():
    assert plan(n=1024, batch=1024, dev=1e9, host=1.0, lat=0.0) <= 1024


def test_many_cores_raise_the_bar():
    # same rates, more host cores -> per-core opportunity cost shrinks,
    # the same marginal device now stays in play; fewer cores bench it
    assert plan(dev=7_000.0, host=25_000.0, cores=16) > 0
    assert plan(dev=7_000.0, host=25_000.0, cores=1) == 0
