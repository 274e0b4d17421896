"""The check must fail a broken timed path and the controls.

Each fault breaks the path under the harness, which then runs as it does
on the card, at a tiny size on the CPU: `correct` has to come out false.
The faults a sort can have: a step that returns its input unchanged;
half the records left out; the exchange between workers left out; one
answer altered where it is produced. The controls (perfbench/controls.py)
are the reference in the program's place at a lower key precision.
"""
import pytest
import torch

from perfbench import controls


def resident_unchanged(_entry):
    def sort(keys, ids, payload, *, num_workers, **_):
        per = keys.shape[0] // num_workers
        valid = torch.full((num_workers,), per, dtype=torch.int32)
        return keys, ids, payload, valid, torch.tensor(False)
    return sort


def resident_half(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, ovf = entry(*args, **kw)
        return mk, mv, pout, valid // 2, ovf
    return sort


def resident_altered(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, ovf = entry(*args, **kw)
        pout = pout.clone()
        pout[0, 3] ^= 1
        return mk, mv, pout, valid, ovf
    return sort


def no_exchange(monkeypatch):
    from repro_torch.core import exoshuffle, payload

    def stay(x, mesh=None, **_):
        return x.contiguous()  # every worker keeps the blocks it would send

    monkeypatch.setattr(exoshuffle, "all_to_all_tiled", stay)
    monkeypatch.setattr(payload, "all_to_all_tiled", stay)


FAULTS = {
    "indy.resident": [resident_unchanged, resident_half, None,
                      resident_altered],
}
CASES = [(w, i) for w in FAULTS for i in range(4)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_path_is_not_correct(workload, fault, small_run,
                                      monkeypatch):
    wrap = FAULTS[workload][fault]
    if wrap is None:
        no_exchange(monkeypatch)
    line = small_run(workload, wrap=wrap)
    assert line["correct"] is False
    assert line["check"]["mismatched_records"]["value"] > 0


@pytest.mark.parametrize("workload", list(FAULTS))
@pytest.mark.parametrize("seed", [11, 2**31 + 13, 2**33 + 17])
def test_the_control_is_not_correct(workload, seed, small_cell):
    out = controls.run_control(small_cell(workload), seed, device="cpu")
    assert not out.correct
    bad = out.checks[0]
    assert bad.name == "mismatched_records" and bad.value > bad.limit


def resident_writes_its_input(entry):
    def sort(keys, ids, payload, **kw):
        out = entry(keys, ids, payload, **kw)
        payload[1, 0] += 1  # the next call no longer sorts the seed's records
        return out
    return sort


def resident_overflows(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, _ = entry(*args, **kw)
        return mk, mv, pout, valid, torch.tensor(True)
    return sort


@pytest.mark.parametrize("wrap,check", [
    (resident_writes_its_input, "input_changed_records"),
    (resident_overflows, "overflow")])
def test_a_sort_that_breaks_its_contract_is_not_correct(wrap, check,
                                                       small_run):
    line = small_run("indy.resident", wrap=wrap)
    assert line["correct"] is False
    assert line["check"][check]["value"] > 0
