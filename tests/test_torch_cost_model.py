"""The port's cost model (core/cost_model.py) against the JAX package's.

The paper's part (Table 2, the measured, tiered and serverless legs) is
a copy: the reference's own unit tests (tests/test_cost_model.py) run
against the port's module, by monkeypatching the names they import. The
H100 part (`GpuCostParams`, `gpu_sort_time_model`, `gpu_cloudsort_tco`)
is the counterpart of the reference's accelerator model: with its
parameters set to match a `TpuPodCostParams` and measured rates too high
to bind, its roofline terms and its whole breakdown equal the
reference's; otherwise the measured time bounds the job's hours.
"""
import dataclasses
import sys

import pytest

import test_cost_model as ref_tests
from repro.core import cost_model as ref
from repro_torch.core import cost_model as port
from repro_torch.io import backends as port_backends

REF_UNITS = sorted(n for n in dir(ref_tests)
                   if n.startswith("test_") and not n.startswith("test_tpu"))


@pytest.mark.parametrize("name", REF_UNITS)
def test_reference_unit_case_on_port(name, monkeypatch):
    for attr in ("CostBreakdown", "Ec2CostParams", "JobProfile",
                 "cloudsort_tco", "measured_tiered_cloudsort_tco"):
        monkeypatch.setattr(ref_tests, attr, getattr(port, attr))
    # the cases that import inside their body get the port's modules
    monkeypatch.setitem(sys.modules, "repro.core.cost_model", port)
    monkeypatch.setitem(sys.modules, "repro.io.backends", port_backends)
    getattr(ref_tests, name)()


def _matching(tpu: ref.TpuPodCostParams, **over) -> port.GpuCostParams:
    """GPU parameters equal to a TPU pod's, measured rates out of the
    way unless given."""
    kw = dict(gpu_hourly=tpu.chip_hourly, num_gpus=tpu.num_chips,
              hbm_gbps=tpu.hbm_gbps, interconnect_gbps=tpu.ici_link_gbps,
              map_records_per_s=1e30, reduce_records_per_s=1e30)
    kw.update(over)
    return port.GpuCostParams(**kw)


@pytest.mark.parametrize("mode", ["through", "late"])
@pytest.mark.parametrize("data_bytes", [1e12, 100e12])
def test_roofline_terms_equal_the_reference(mode, data_bytes):
    tpu = ref.TpuPodCostParams()
    want = ref.tpu_sort_time_model(data_bytes, tpu, payload_mode=mode)
    got = port.gpu_sort_time_model(data_bytes, _matching(tpu),
                                   payload_mode=mode)
    for key in ("t_network_s", "t_memory_s", "t_total_s", "job_hours"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["t_measured_s"] < got["t_total_s"]


@pytest.mark.parametrize("mode", ["through", "late"])
@pytest.mark.parametrize("data_bytes", [1e12, 100e12])
def test_breakdown_and_s3_legs_equal_the_reference(mode, data_bytes):
    tpu = ref.TpuPodCostParams()
    want = ref.tpu_cloudsort_tco(data_bytes, tpu, payload_mode=mode)
    got = port.gpu_cloudsort_tco(data_bytes, _matching(tpu),
                                 payload_mode=mode)
    assert isinstance(got, port.CostBreakdown)
    for (name, g), (_, w) in zip(got.rows(), want.rows()):
        assert g == pytest.approx(w, rel=1e-12), name


def test_measured_rates_bound_the_job_hours():
    p = port.GpuCostParams()
    t = port.gpu_sort_time_model(100e12, p)
    records = 100e12 / 100 / p.num_gpus
    assert t["t_measured_s"] == pytest.approx(
        records / p.map_records_per_s + records / p.reduce_records_per_s)
    assert t["job_hours"] == pytest.approx(
        max(t["t_total_s"], t["t_measured_s"]) / 3600)
    # the defaults: the full run's measured rates, far below the roofline
    assert t["t_measured_s"] > t["t_total_s"]
    faster = dataclasses.replace(p, map_records_per_s=2 * p.map_records_per_s,
                                 reduce_records_per_s=2
                                 * p.reduce_records_per_s)
    assert port.gpu_sort_time_model(100e12, faster)["t_measured_s"] == \
        pytest.approx(t["t_measured_s"] / 2)


def test_compute_cost_is_linear_in_the_hourly_price():
    base = port.GpuCostParams()
    costs = [port.gpu_cloudsort_tco(
        100e12, dataclasses.replace(base, gpu_hourly=k * base.gpu_hourly))
        for k in (1, 2, 3)]
    assert costs[1].compute == pytest.approx(2 * costs[0].compute)
    assert costs[2].compute == pytest.approx(3 * costs[0].compute)
    for c in costs[1:]:  # nothing else moves
        assert c.storage_input == costs[0].storage_input
        assert c.access_put == costs[0].access_put


@pytest.mark.parametrize("knob,value", [
    ("gpu_hourly", 0.0), ("gpu_hourly", -1.0), ("hbm_gbps", 0.0),
    ("interconnect_gbps", -5.0), ("map_records_per_s", 0.0),
    ("reduce_records_per_s", -1.0), ("num_gpus", 0), ("num_gpus", 2.5)])
def test_every_knob_is_validated(knob, value):
    with pytest.raises(ValueError, match=knob):
        port.GpuCostParams(**{knob: value})


@pytest.mark.parametrize("kw,knob", [
    (dict(data_bytes=0.0), "data_bytes"),
    (dict(data_bytes=1e12, payload_mode="early"), "payload_mode"),
    (dict(data_bytes=1e12, num_rounds=0), "num_rounds")])
def test_time_model_arguments_are_validated(kw, knob):
    with pytest.raises(ValueError, match=knob):
        port.gpu_sort_time_model(p=port.GpuCostParams(), **kw)


def test_e2e_example_prints_the_gpu_cost_line(capsys):
    from repro_torch.examples import cloudsort_e2e

    out = cloudsort_e2e.main(["--records", str(1 << 14), "--device", "cpu"])
    rate = out["records_per_s"]
    want = port.gpu_cloudsort_tco(p=port.GpuCostParams(
        map_records_per_s=2 * rate, reduce_records_per_s=2 * rate))
    assert out["gpu_tco"] == pytest.approx(want.total)
    text = capsys.readouterr().out
    assert f"320 x H100 100TB TCO (modeled, through, at this run's " \
        f"{rate:,.0f} rec/s on cpu) = ${want.total:.2f}" in text
