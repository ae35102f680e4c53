"""The port's Megatron pretraining samplers
(``apex_tpu_torch.transformer._data``) and the harness's ``global_vars``
(``apex_tpu_torch.transformer.testing.global_vars``) against the JAX
package's.

Both are pure Python.  Every sampler case runs through both packages and
must yield the same index lists, exactly (the JAX package permutes with
``numpy.random.RandomState(epoch)``, and so does the port); the cases are
``tests/test_batchsampler.py``'s and more (every rank, resumes, the
partial tail with and without ``drop_last``, a second epoch), and each
bad argument raises ``ValueError`` in both.  The ``global_vars``
scenarios of ``tests/test_aux_subsystems.py`` (the args registry, the
sentinel-file and environment protocols, the poll interval, the save
callback) run through both modules and give the same answers.
"""

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.transformer import _data as jdata
from apex_tpu.transformer.testing import global_vars as jgv
from apex_tpu_torch.transformer import _data as tdata
from apex_tpu_torch.transformer.testing import global_vars as tgv

# (total, consumed, local minibatch, dp, drop_last) for every rank
CONTIGUOUS = [(32, 0, 2, 4, True), (10, 4, 2, 2, False), (10, 4, 2, 2, True),
              (37, 5, 3, 2, False), (8, 0, 8, 1, True)]
# (total, consumed, local minibatch, dp) for every rank
RANDOM = [(64, 0, 4, 2), (64, 64, 4, 2), (64, 16, 4, 2), (70, 0, 4, 2),
          (70, 100, 3, 3), (12, 0, 4, 1)]


def _contiguous(mod, total, consumed, lmb, dp, drop_last):
    return [list(mod.MegatronPretrainingSampler(
        total_samples=total, consumed_samples=consumed,
        local_minibatch_size=lmb, data_parallel_rank=r,
        data_parallel_size=dp, drop_last=drop_last)) for r in range(dp)]


def _random(mod, total, consumed, lmb, dp):
    out = []
    for r in range(dp):
        s = mod.MegatronPretrainingRandomSampler(
            total_samples=total, consumed_samples=consumed,
            local_minibatch_size=lmb, data_parallel_rank=r,
            data_parallel_size=dp)
        out.append((len(s), list(s), s.consumed_samples, s.epoch))
    return out


@pytest.mark.parametrize("case", CONTIGUOUS, ids=str)
def test_contiguous_sampler_matches_jax(case):
    got, want = _contiguous(tdata, *case), _contiguous(jdata, *case)
    assert got == want
    total, consumed, lmb, dp, drop_last = case
    steps = [sorted(i for rank in got for i in rank[k])
             for k in range(len(got[0]))]
    assert [i for step in steps for i in step] == list(
        range(consumed, consumed + sum(map(len, steps))))


@pytest.mark.parametrize("case", RANDOM, ids=str)
def test_random_sampler_matches_jax(case):
    got, want = _random(tdata, *case), _random(jdata, *case)
    assert got == want
    flats = [set(i for b in rank[1] for i in b) for rank in got]
    assert all(a.isdisjoint(b) for i, a in enumerate(flats)
               for b in flats[i + 1:])


def test_random_sampler_resumes_mid_epoch_and_reshuffles():
    """``tests/test_batchsampler.py``'s resume: 16 consumed (8 a rank)
    skips the first two minibatches; a whole epoch consumed reshuffles."""
    kw = dict(total_samples=64, local_minibatch_size=4, data_parallel_rank=0,
              data_parallel_size=2)
    epoch0 = list(tdata.MegatronPretrainingRandomSampler(
        consumed_samples=0, **kw))
    assert list(tdata.MegatronPretrainingRandomSampler(
        consumed_samples=16, **kw)) == epoch0[2:]
    assert list(tdata.MegatronPretrainingRandomSampler(
        consumed_samples=64, **kw)) != epoch0


BAD = [("contiguous", (0, 0, 2, 0, 2)), ("contiguous", (8, 8, 2, 0, 2)),
       ("contiguous", (8, 0, 2, 2, 2)), ("contiguous", (8, 0, 0, 0, 2)),
       ("contiguous", (8, 0, 2, 0, 0)), ("random", (4, 0, 4, 0, 2)),
       ("random", (8, 0, 2, 3, 2))]


@pytest.mark.parametrize("kind,args", BAD, ids=str)
def test_bad_arguments_raise_as_in_jax(kind, args):
    name = ("MegatronPretrainingSampler" if kind == "contiguous"
            else "MegatronPretrainingRandomSampler")
    for mod in (jdata, tdata):
        with pytest.raises(ValueError):
            getattr(mod, name)(*args)


def test_local_minibatch_size_setter_matches_jax():
    out = []
    for mod in (jdata, tdata):
        s = mod.MegatronPretrainingSampler(40, 0, 2, 1, 4)
        s.local_minibatch_size = 3
        out.append((s.local_minibatch_times_data_parallel_size,
                    s.get_start_end_idx(), list(s)))
    assert out[0] == out[1]


def _global_vars_scenario(gv, tmp_path, monkeypatch):
    """The reference's ``global_vars`` behaviours, as a trace of answers."""
    trace = []
    tmp_path.mkdir()
    gv.set_args(None)
    with pytest.raises(RuntimeError):
        gv.get_args()
    gv.set_args({"lr": 0.1})
    trace.append(gv.get_args()["lr"])
    gv.set_args(None)

    sig = tmp_path / "preempt"
    ar = gv.AutoResume(signal_file=str(sig), min_poll_interval=0.0)
    gv.set_autoresume(ar)
    assert gv.get_autoresume() is ar
    saved = []
    trace.append(gv.check_autoresume_termination(1, saved.append))
    sig.write_text("now")
    trace.append(gv.check_autoresume_termination(2, saved.append))
    trace += [list(saved), sig.exists()]

    slow = gv.AutoResume(signal_file=str(sig), min_poll_interval=0.0)
    trace.append(slow.termination_requested())
    slow.min_poll_interval = 3600.0
    sig.write_text("now")
    trace.append(slow.termination_requested())   # within the interval
    slow.min_poll_interval = 0.0
    slow.init()
    trace.append(slow.termination_requested())
    slow.request_resume()
    trace.append(sig.exists())

    monkeypatch.setenv("APEX_TPU_AUTORESUME_TERMINATE", "1")
    env = gv.AutoResume(min_poll_interval=0.0)
    trace.append(env.termination_requested())
    for off in ("0", "false", "no", "off", ""):
        monkeypatch.setenv("APEX_TPU_AUTORESUME_TERMINATE", off)
        env.init()
        trace.append(env.termination_requested())
    monkeypatch.delenv("APEX_TPU_AUTORESUME_TERMINATE")
    gv.set_autoresume(None)
    trace.append(gv.check_autoresume_termination(3, saved.append))
    return trace


def test_global_vars_behave_as_jax(tmp_path, monkeypatch):
    want = _global_vars_scenario(jgv, tmp_path / "jax", monkeypatch)
    got = _global_vars_scenario(tgv, tmp_path / "port", monkeypatch)
    assert got == want == [0.1, False, True, [2], False, False, False, True,
                           False, True, False, False, False, False, False,
                           False]


def test_autoresume_checks_the_flag_over_a_process_group(tmp_path,
                                                         monkeypatch):
    """Inside a (one-rank, gloo) process group the flag goes through the
    all-reduce and the answer is this rank's."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import launch

    launch.initialize_distributed(f"127.0.0.1:{launch.free_port()}", 1, 0,
                                  backend="gloo")
    try:
        sig = tmp_path / "preempt"
        tgv.set_autoresume(tgv.AutoResume(signal_file=str(sig),
                                          min_poll_interval=0.0))
        saved = []
        assert not tgv.check_autoresume_termination(1, saved.append)
        sig.write_text("now")
        assert tgv.check_autoresume_termination(2, saved.append)
        assert saved == [2] and dist.get_world_size() == 1
    finally:
        tgv.set_autoresume(None)
        dist.destroy_process_group()
    assert not torch.distributed.is_initialized()
