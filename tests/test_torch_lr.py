"""paddle_tpu_torch's LR schedulers against the JAX package's.

Every scheduler of ``optimizer/lr.py`` runs 30 steps in both packages
from the same settings; the learning rates must be equal as Python
floats (the two files compute the same host arithmetic).  A scheduler's
``state_dict`` taken mid-run restores a fresh one that then continues
exactly; the port's ``state_dict`` equals the JAX package's.  The
optimizer writes the scheduler's value into its 0-d device scalar before
each step."""
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30

SCHEDULERS = {
    "noam": lambda L: L.NoamDecay(64, 5, learning_rate=2.0),
    "piecewise": lambda L: L.PiecewiseDecay([3, 10, 20],
                                            [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda L: L.NaturalExpDecay(0.1, 0.3),
    "inverse_time": lambda L: L.InverseTimeDecay(0.1, 0.5),
    "polynomial": lambda L: L.PolynomialDecay(0.1, 10, end_lr=0.001,
                                              power=2.0),
    "polynomial_cycle": lambda L: L.PolynomialDecay(0.1, 7, cycle=True),
    "linear_warmup": lambda L: L.LinearWarmup(0.1, 5, 0.0, 0.1),
    "linear_warmup_cosine": lambda L: L.LinearWarmup(
        L.CosineAnnealingDecay(0.1, 12), 5, 0.01, 0.1),
    "exponential": lambda L: L.ExponentialDecay(0.1, 0.9),
    "multistep": lambda L: L.MultiStepDecay(0.1, [4, 9, 15], 0.5),
    "step": lambda L: L.StepDecay(0.1, 4, 0.7),
    "lambda": lambda L: L.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "cosine": lambda L: L.CosineAnnealingDecay(0.1, 10, eta_min=0.001),
    "cyclic": lambda L: L.CyclicLR(0.01, 0.1, 4, 6),
    "cyclic_triangular2": lambda L: L.CyclicLR(0.01, 0.1, 3,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda L: L.CyclicLR(0.01, 0.1, 3, mode="exp_range",
                                             exp_gamma=0.9),
    "one_cycle": lambda L: L.OneCycleLR(0.1, 25),
    "one_cycle_short": lambda L: L.OneCycleLR(0.1, 3, phase_pct=0.1),
}

# the metric sequence ReduceOnPlateau reads (improves, stalls, improves)
PLATEAU_METRICS = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.8, 0.85, 0.85, 0.9,
                   0.9, 0.9, 0.7, 0.71, 0.72, 0.73, 0.74, 0.75, 0.69, 0.7,
                   0.7, 0.7, 0.7, 0.7, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]


def _trajectory(sched, steps=STEPS):
    out = []
    for _ in range(steps):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_matches_jax_exactly(name):
    make = SCHEDULERS[name]
    want = _trajectory(make(jlr))
    got = _trajectory(make(tlr))
    assert got == want
    assert all(isinstance(v, float) for v in got)


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_state_dict_round_trip(name):
    make = SCHEDULERS[name]
    ref, sched = make(jlr), make(tlr)
    _trajectory(ref, 13)
    _trajectory(sched, 13)
    sd = sched.state_dict()
    assert sd == ref.state_dict()
    fresh = make(tlr)
    fresh.set_state_dict(dict(sd))
    assert _trajectory(fresh, 10) == _trajectory(sched, 10)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_on_plateau_matches_jax(mode):
    metrics = (PLATEAU_METRICS if mode == "min"
               else [-m for m in PLATEAU_METRICS])

    def run(L):
        s = L.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=2,
                              cooldown=1, min_lr=0.01)
        lrs = []
        for i, m in enumerate(metrics):
            s.step(m if i % 3 else np.float32(m))
            lrs.append(s())
        return lrs, s

    want, ref = run(jlr)
    got, sched = run(tlr)
    assert got == want
    assert len(set(got)) > 2                      # it did reduce
    assert sched.state_dict() == ref.state_dict()
    fresh = tlr.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=2,
                                cooldown=1, min_lr=0.01)
    fresh.set_state_dict(dict(sched.state_dict()))
    for m in metrics[:10]:
        fresh.step(m)
        sched.step(m)
        assert fresh() == sched()


def test_optimizer_reads_the_scheduler_through_its_device_scalar():
    """``get_lr`` follows the scheduler; ``_prepare_step`` writes it and
    the step count into the 0-d float64 scalars the rules read;
    ``set_lr`` refuses a scheduler; the state_dict carries it."""
    sched = tlr.StepDecay(0.1, 2, 0.5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(sched, parameters=[p])
    lrs = []
    for _ in range(5):
        p.grad = torch.ones(3)
        opt.step()
        lr_t, step_t = opt._scalars()
        assert lr_t.dtype == torch.float64 and lr_t.dim() == 0
        lrs.append(float(lr_t))
        assert float(step_t) == opt._step_count
        sched.step()
    assert lrs == [0.1, 0.1, 0.05, 0.05, 0.025]
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.3)
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 5 and sd["step_count"] == 5
    opt2 = topt.SGD(tlr.StepDecay(0.1, 2, 0.5), parameters=[p])
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == opt.get_lr() == 0.025
