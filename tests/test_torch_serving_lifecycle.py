"""The port engine's lifecycle against the JAX package's: drain (queued
requests REJECTED, in-flight ones finish), drain past its budget,
deadlines, and the retry/fail ladder of a decode dispatch under one
``FaultPlan`` — the same terminal states, tokens and counters in both
packages — plus health, close, the scheduler's drain/expiry halves, the
fault plan itself, and the knobs that wait for ``monitor/``.
"""

import pytest

from paddle_tpu.monitor import metrics as jmx
from paddle_tpu.reliability import faults as jfaults
from paddle_tpu.serving import metrics as jsm
from paddle_tpu_torch.monitor import metrics as tmx
from paddle_tpu_torch.reliability import faults as tfaults
from paddle_tpu_torch.serving import Request, Scheduler
from paddle_tpu_torch.serving import metrics as tsm
from torch_serving_util import engine, jserving, make_stream, tserving

FAULTS = {jserving: jfaults, tserving: tfaults}


def outcome(reqs):
    return [(r.state, list(r.tokens_out)) for r in reqs]


def drain_run(pkg):
    eng = engine(pkg, slots=2)
    reqs = [eng.submit(p, m) for p, m in make_stream(4, seed=2)]
    eng.step()
    assert eng.scheduler.occupancy == 2 and eng.scheduler.queue_depth == 2
    eng.request_drain()
    with pytest.raises(pkg.DrainingError):
        eng.submit([1, 2, 3], 2)
    summary = eng.drain(timeout_s=30.0)
    return eng, reqs, summary


def test_drain_finishes_inflight_and_rejects_queued_as_jax():
    jeng, jreqs, jsum = drain_run(jserving)
    eng, reqs, summary = drain_run(tserving)
    assert summary == jsum == {"finished": 2, "timed_out": 0, "failed": 0,
                               "rejected": 2}
    assert outcome(reqs) == outcome(jreqs)
    assert sorted(r.state for r in reqs) == ["finished", "finished",
                                             "rejected", "rejected"]
    assert eng.pool.num_used == 0 and eng.page_accounting_ok()
    assert eng._closed and eng.last_drain is summary
    assert eng.drain() is summary  # idempotent
    for r in reqs:
        if r.state == "rejected":
            assert not r.pages and r.slot is None


def test_drain_past_its_budget_times_out_stragglers():
    for pkg in (jserving, tserving):
        eng = engine(pkg, slots=2)
        r1 = eng.submit(list(range(8)), 8)
        eng.step()
        summary = eng.drain(timeout_s=0.0)
        assert summary["timed_out"] == 1 and r1.state == "timeout"
        assert not r1.pages and eng.pool.num_used == 0


def test_drain_interrupts_run_and_is_reentrant():
    eng = engine(tserving, slots=2)
    reqs = [eng.submit(p, 6) for p, _ in make_stream(2, seed=4)]
    eng.step()
    eng.request_drain()
    eng.run(max_steps=100)
    assert eng.last_drain["finished"] == 2
    assert all(r.state == "finished" for r in reqs)

    eng = engine(tserving, slots=2)
    [eng.submit(p, 4) for p, _ in make_stream(2, seed=5)]
    eng.step()
    nested, real_step = [], eng.step

    def step_and_reenter():
        nested.append(eng.drain())
        return real_step()

    eng.step = step_and_reenter
    summary = eng.drain(timeout_s=10.0)
    assert nested and all(s is not summary for s in nested)
    assert eng.last_drain is summary and summary["finished"] == 2


def deadline_run(pkg):
    """Two requests with deadlines already spent — one running, one
    queued behind a full batch — and two without."""
    eng = engine(pkg, slots=2)
    stream = make_stream(4, seed=6, max_new=6)
    reqs = [eng.submit(stream[0][0], 20, deadline_s=0.0),
            eng.submit(stream[1][0], stream[1][1]),
            eng.submit(stream[2][0], stream[2][1], deadline_s=0.0),
            eng.submit(stream[3][0], stream[3][1])]
    eng.run(max_steps=100)
    return eng, reqs


def test_deadlines_time_out_as_jax():
    jeng, jreqs = deadline_run(jserving)
    eng, reqs = deadline_run(tserving)
    assert outcome(reqs) == outcome(jreqs)
    assert [r.state for r in reqs] == ["timeout", "finished", "timeout",
                                       "finished"]
    assert eng.pool.num_used == 0 and eng.page_accounting_ok()


def fault_run(pkg, retries, plan_text):
    """The stream under ``plan_text`` at ``serving.decode``, then a fresh
    request after it: (terminal states and tokens, the fresh request's,
    health, faults fired)."""
    f = FAULTS[pkg]
    eng = engine(pkg, decode_retries=retries)
    plan = f.FaultPlan.parse(plan_text)
    with plan:
        reqs = [eng.submit(p, m) for p, m in make_stream(4, seed=7)]
        eng.run(max_steps=200)
    health = eng.health()
    after = eng.submit([5, 6, 7, 8], 4)
    eng.run()
    assert eng.pool.num_used == 0 and eng.page_accounting_ok()
    return outcome(reqs), outcome([after]), health, plan.fired, eng.health()


@pytest.mark.parametrize("retries,plan", [
    (2, "serving.decode@2=transient:2;serving.decode@4=fatal"),
    (2, "serving.decode@3=transient:3"),
    (0, "serving.decode@1=transient"),
    (2, "serving.decode@2=exhausted"),
])
def test_retry_and_fail_ladder_as_jax(retries, plan):
    jmx.enable()
    tmx.enable()
    j0 = (jsm.RETRIES.value, jsm.FAULTS.value)
    t0 = (tsm.RETRIES.value, tsm.FAULTS.value)
    want = fault_run(jserving, retries, plan)
    got = fault_run(tserving, retries, plan)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    for key in ("status", "consecutive_failures", "faults_absorbed",
                "page_accounting_ok", "prefills", "resumes", "running"):
        assert got[2][key] == want[2][key], key
    assert got[2]["last_error"].split(":")[0] == \
        want[2]["last_error"].split(":")[0]
    assert got[4]["status"] == "ok"
    assert got[1][0][0] == "finished"
    assert any(s == "failed" for s, _ in got[0])
    assert tsm.RETRIES.value - t0[0] == jsm.RETRIES.value - j0[0]
    assert tsm.FAULTS.value - t0[1] == jsm.FAULTS.value - j0[1] >= 1


def test_retries_absorb_transients_without_failing():
    """Two transients at one dispatch under a budget of 2: both retried,
    no request fails, the streams are the fault-free ones."""
    tmx.enable()
    eng = engine(tserving, decode_retries=2)
    r0 = tsm.RETRIES.value
    with tfaults.FaultPlan.parse("serving.decode@2=transient:2"):
        reqs = [eng.submit(p, m) for p, m in make_stream(4, seed=8)]
        eng.run()
    assert tsm.RETRIES.value - r0 == 2
    ref = engine(tserving)
    want = [ref.submit(p, m) for p, m in make_stream(4, seed=8)]
    ref.run()
    assert outcome(reqs) == outcome(want)
    assert eng.health()["status"] == "ok"


def test_fail_fast_raises_the_fault():
    eng = engine(tserving, fail_fast=True)
    eng.submit([1, 2, 3], 4)
    with tfaults.FaultPlan.parse("serving.decode@1=fatal"):
        with pytest.raises(tfaults.InjectedFault):
            eng.run()


def test_health_close_and_context_manager():
    with engine(tserving) as eng:
        h = eng.health()
        assert h["status"] == "ok" and h["page_accounting_ok"]
        assert h["pages_total"] == 4 * 64 // 8 and h["pages_free"] == 32
        r = eng.submit([1, 2, 3], 3)
        eng.run()
        assert r.state == "finished" and eng.health()["prefills"] == 1
    assert eng._closed
    eng.close()
    s = eng.drain(timeout_s=1.0)
    assert s["finished"] == 0 and eng.drain() is s


def test_knobs_that_wait_for_monitor_raise():
    with pytest.raises(NotImplementedError, match="monitor"):
        tserving.ServingConfig(kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="monitor"):
        tserving.ServingConfig(slos=["p99"])
    with pytest.raises(ValueError):
        tserving.ServingConfig(kv_dtype="fp8")
    cfg = tserving.ServingConfig(slos=[])
    assert cfg.slos == []


def test_scheduler_drain_queue_and_drop_expired():
    sch = Scheduler(2)
    reqs = [sch.submit(Request([1, 2], 2, deadline_s=(0.0 if i % 2 else
                                                      None)))
            for i in range(4)]
    expired = sch.drop_expired(reqs[0].submitted_t + 1.0)
    assert [r.state for r in expired] == ["timeout", "timeout"]
    assert sch.queue_depth == 2
    shed = sch.drain_queue()
    assert [r.state for r in shed] == ["rejected", "rejected"]
    assert sch.queue_depth == 0 and sch.idle()


def test_fault_plan_grammar_and_classify_as_jax():
    text = "serving.decode@3=transient:2;page_pool.alloc@1=exhausted"
    t = tfaults.FaultPlan.parse(text)
    j = jfaults.FaultPlan.parse(text)
    assert repr(t.specs) == repr(j.specs)
    assert tfaults.SITES == jfaults.SITES and tfaults.KINDS == jfaults.KINDS
    fired = [t.poll("serving.decode") is not None for _ in range(5)]
    assert fired == [False, False, True, True, False] and t.fired == 2
    with pytest.raises(ValueError):
        tfaults.FaultPlan.parse("nowhere@1=fatal")
    pairs = [(tfaults.TransientFault("x"), jfaults.TransientFault("x")),
             (tfaults.InjectedFault("x"), jfaults.InjectedFault("x")),
             (RuntimeError("UNAVAILABLE: socket closed"),) * 2,
             (RuntimeError("boom"),) * 2,
             (tserving.BackpressureError("full"),
              jserving.BackpressureError("full"))]
    for port_exc, jax_exc in pairs:
        assert tfaults.classify(port_exc) == jfaults.classify(jax_exc)
    assert tfaults.current_plan() is None
    with t:
        assert tfaults.current_plan() is t
    assert tfaults.current_plan() is None
