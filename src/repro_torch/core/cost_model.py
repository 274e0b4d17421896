"""Total-cost-of-ownership model (paper §3.3.2, Table 2) + H100 variant.

Reproduces the paper's arithmetic exactly — compute $/hr x job hours, S3
storage-hours for input/output, and per-request GET/PUT fees — prices a
run from its measured request counts, and provides an H100 GPU
re-parameterization of the adapted system (the counterpart of the
reference's accelerator re-parameterization), so that a run of the port
can report a CloudSort TCO for its design.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Ec2CostParams:
    """Paper values (§3.3.2, November 2022, us-west-2 on-demand)."""

    master_hourly: float = 0.504  # r6i.2xlarge
    worker_hourly: float = 1.373  # i4i.4xlarge
    num_workers: int = 40
    ebs_gb: int = 40
    ebs_month_per_gb: float = 0.08
    hours_per_month: float = 365 * 24 / 12  # 730

    # S3 (first 50 TB / next 450 TB tiers averaged for a 100 TB dataset)
    s3_gb_month_tier1: float = 0.023
    s3_gb_month_tier2: float = 0.022
    get_per_1000: float = 0.0004
    put_per_1000: float = 0.005

    # Local-SSD spill tier (§2.3): i4i instance NVMe is bundled into
    # worker_hourly, so its marginal $/GB-month is 0 and spill requests
    # are free. Nonzero models an EBS-gp3-style attached-volume spill.
    ssd_gb_month: float = 0.0

    @property
    def ebs_hourly(self) -> float:
        # The paper rounds this intermediate to $0.0044 before Equation (1)
        # ("$0.08/730 x 40 = $0.0044"); match its arithmetic to the cent.
        return round(self.ebs_month_per_gb / self.hours_per_month
                     * self.ebs_gb, 4)

    @property
    def cluster_hourly(self) -> float:
        """Equation (1)."""
        return (
            self.master_hourly
            + self.worker_hourly * self.num_workers
            + self.ebs_hourly * (self.num_workers + 1)
        )

    def s3_hourly_per_100tb(self) -> float:
        avg_gb_month = (self.s3_gb_month_tier1 + self.s3_gb_month_tier2) / 2
        return avg_gb_month * 100_000 / self.hours_per_month


@dataclasses.dataclass(frozen=True)
class JobProfile:
    """Measured run profile (paper Table 1 averages)."""

    # The paper rounds to 4 decimals before multiplying; match it exactly.
    job_hours: float = 1.4939  # 5378 s
    reduce_hours: float = 0.5194  # 1870 s
    get_requests: int = 6_000_000  # 50k maps x 120 chunks
    put_requests: int = 1_000_000  # 25k reduces x 40 chunks


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute: float
    storage_input: float
    storage_output: float
    access_get: float
    access_put: float
    # Tiered-store leg (0 in the paper's Table 2: i4i NVMe spill is
    # bundled into the instance price). Populated by the tiered measured
    # path when ssd_gb_month is nonzero.
    storage_spill: float = 0.0

    @property
    def total(self) -> float:
        return (
            self.compute
            + self.storage_input
            + self.storage_output
            + self.storage_spill
            + self.access_get
            + self.access_put
        )

    def rows(self):
        return [
            ("compute_vm_cluster", self.compute),
            ("data_storage_input", self.storage_input),
            ("data_storage_output", self.storage_output),
            ("data_storage_spill_ssd", self.storage_spill),
            ("data_access_input_get", self.access_get),
            ("data_access_output_put", self.access_put),
            ("total", self.total),
        ]


def cloudsort_tco(
    params: Ec2CostParams = Ec2CostParams(),
    profile: JobProfile = JobProfile(),
    *,
    data_tb: float = 100.0,
) -> CostBreakdown:
    """Table 2. With default arguments returns the paper's $96.6728.

    `data_tb` scales the storage-hour legs for datasets other than the
    100 TB record run; the request legs are already absolute through the
    profile's counts.
    """
    s3_hr = params.s3_hourly_per_100tb() * (data_tb / 100.0)
    return CostBreakdown(
        compute=params.cluster_hourly * profile.job_hours,
        storage_input=s3_hr * profile.job_hours,
        storage_output=s3_hr * profile.reduce_hours,
        access_get=params.get_per_1000 * profile.get_requests / 1000,
        access_put=params.put_per_1000 * profile.put_requests / 1000,
    )


def measured_job_profile(stats, *, job_hours: float, reduce_hours: float) -> JobProfile:
    """JobProfile from *measured* store counters, not Table-1 constants.

    `stats` is duck-typed: anything with .get_requests / .put_requests —
    in practice io.backends.StoreStats deltas captured by
    core.external_sort (the store counts every chunked map GET, ranged
    reduce GET, spill PUT and multipart-upload part PUT it actually
    served). Under a fault-injected store the counters are retry-inflated
    by construction (io/middleware.MetricsMiddleware counts every issued
    attempt, throttled or not), so the access legs price the real request
    traffic a retrying client generates, not the logical operation count.
    """
    return JobProfile(
        job_hours=job_hours,
        reduce_hours=reduce_hours,
        get_requests=int(stats.get_requests),
        put_requests=int(stats.put_requests),
    )


def measured_cloudsort_tco(
    stats,
    *,
    job_hours: float,
    reduce_hours: float,
    data_bytes: float,
    params: Ec2CostParams = Ec2CostParams(),
) -> CostBreakdown:
    """Table 2 priced from an actual run: measured request counts and
    timings (core.external_sort.ExternalSortReport), storage legs scaled
    to the dataset actually sorted.

    Which Table-2 legs are MEASURED here and which are still ASSUMED:

      measured — data_access_input_get / data_access_output_put come
          from the run's StoreStats deltas: every chunked map GET,
          ranged reduce GET, spill PUT and multipart part PUT the store
          actually served, instead of the paper's 50k x 120 = 6M GET /
          25k x 40 = 1M PUT arithmetic. job_hours / reduce_hours (the
          storage-hour multipliers) are the run's wall clock.

      assumed — the EC2 price sheet (Ec2CostParams: $/hr for master/
          worker/EBS, S3 $/GB-month tiers, per-1000 request fees) is
          carried over from the paper's November-2022 us-west-2 rates;
          an emulated run can't measure prices. The storage-hour legs
          also assume the paper's layout: the dataset sits in S3 for the
          whole job (input leg) and output accretes over the reduce
          phase (output leg).

    Retry-inflated attempt counts are deliberately the billing basis:
    MetricsMiddleware counts every *issued* attempt — throttled 503s and
    backoff re-issues included — because S3 bills requests, not logical
    operations. A client that retries its way through a throttling
    regime pays for the retries; pricing the logical count would
    understate exactly the §3.3.2 cost the paper's request-fee analysis
    is about. (Cluster re-execution after a worker failure inflates the
    same way: a re-run task's requests are real, billed traffic.)
    """
    profile = measured_job_profile(stats, job_hours=job_hours, reduce_hours=reduce_hours)
    return cloudsort_tco(params, profile, data_tb=data_bytes / 1e12)


def measured_tiered_cloudsort_tco(
    tier_stats,
    *,
    job_hours: float,
    reduce_hours: float,
    data_bytes: float,
    params: Ec2CostParams = Ec2CostParams(),
) -> CostBreakdown:
    """Table 2 priced from a tiered run: only the DURABLE tier's requests
    hit the S3 access legs (the paper's 6M GET / 1M PUT arithmetic never
    included spill traffic — spill goes to local SSD, §2.3), while the
    SSD tier's bytes price the spill-storage leg at ssd_gb_month (0 for
    bundled instance NVMe, like the paper's i4i workers).

    Measured vs. assumed, on top of measured_cloudsort_tco's split: the
    durable/ssd request partition is measured (TieredStore routes by key
    prefix and meters each tier separately), and the durable counters
    are retry-inflated like a real bill — the right basis, since only
    durable attempts cost money while SSD attempts are free however
    often a retry or a re-executed cluster task re-issues them. Assumed:
    spill capacity is billed by bytes *written* over job_hours (an
    attached-volume upper bound; with the default ssd_gb_month=0 the leg
    is $0, matching Table 2's bundled i4i NVMe).

    `tier_stats` is core.external_sort.ExternalSortReport.tier_stats:
    a {"durable": StoreStats, "ssd": StoreStats} delta mapping from
    io.tiered.TieredStore.per_tier_stats().
    """
    durable = tier_stats["durable"]
    ssd = tier_stats.get("ssd")
    base = measured_cloudsort_tco(
        durable, job_hours=job_hours, reduce_hours=reduce_hours,
        data_bytes=data_bytes, params=params)
    spill = 0.0
    if ssd is not None and params.ssd_gb_month:
        spill_gb = ssd.bytes_written / 1e9
        spill = (params.ssd_gb_month / params.hours_per_month
                 * spill_gb * job_hours)
    return dataclasses.replace(base, storage_spill=spill)


# ---------------------------------------------------------------------------
# Serverless: the per-invocation GB-second pricing leg (ROADMAP item 2)
# ---------------------------------------------------------------------------


def _require(cond: bool, knob: str, value, why: str) -> None:
    if not cond:
        raise ValueError(f"{knob}={value!r}: {why}")


@dataclasses.dataclass(frozen=True)
class ServerlessCostParams:
    """Lambda-style function pricing (x86 on-demand, us-west-2, late 2022).

    The compute leg bills GB-seconds: billed duration (rounded UP to
    `duration_step_ms`) times the function's memory size (peak usage
    rounded UP to `memory_step_mib`, floored at `memory_floor_mib` — the
    smallest size the platform sells), plus a flat `per_invocation` fee.
    The object-store legs are unchanged from the paper's S3 model
    (`s3`): serverless-sort and BlobShuffle both show the request fees,
    not the compute meter, are where object-store shuffle cost lives.

    `equivalent_worker_memory_gb` / `invocations_per_100tb` parameterize
    the closed-form sweep (`serverless_tco_at`): a function fleet doing
    the paper's 100 TB job buys the same GB-hours the 40 i4i.4xlarge
    workers (128 GB each) held for `job_hours`, sliced into the paper's
    50k map + 25k reduce task invocations.
    """

    gb_second: float = 1.66667e-5  # $ per GB-second of billed duration
    per_invocation: float = 2e-7  # $0.20 per 1M requests
    memory_floor_mib: int = 128  # smallest purchasable function size
    memory_step_mib: int = 1  # memory-size granularity
    duration_step_ms: float = 1.0  # billed-duration granularity
    equivalent_worker_memory_gb: float = 128.0  # i4i.4xlarge
    invocations_per_100tb: int = 75_000  # 50k maps + 25k reduces
    s3: Ec2CostParams = Ec2CostParams()

    def __post_init__(self):
        _require(self.gb_second > 0, "gb_second", self.gb_second,
                 "the GB-second rate must be positive")
        _require(self.per_invocation >= 0, "per_invocation",
                 self.per_invocation, "the per-request fee must be >= 0")
        _require(self.memory_floor_mib > 0, "memory_floor_mib",
                 self.memory_floor_mib,
                 "the smallest function size must be positive")
        _require(self.memory_step_mib > 0, "memory_step_mib",
                 self.memory_step_mib,
                 "the memory-size granularity must be positive")
        _require(self.duration_step_ms > 0, "duration_step_ms",
                 self.duration_step_ms,
                 "the billed-duration granularity must be positive")
        _require(self.equivalent_worker_memory_gb > 0,
                 "equivalent_worker_memory_gb",
                 self.equivalent_worker_memory_gb,
                 "the per-worker memory equivalence must be positive")
        _require(self.invocations_per_100tb >= 0, "invocations_per_100tb",
                 self.invocations_per_100tb,
                 "the invocation count must be >= 0")


@dataclasses.dataclass(frozen=True)
class InvocationProfile:
    """One function invocation as the meter saw it: billed wall-clock
    and measured peak memory (cloud.function_worker.InvocationRecord
    carries the measurement; this is the pricing-facing slice)."""

    seconds: float
    peak_bytes: int

    def __post_init__(self):
        _require(self.seconds >= 0, "seconds", self.seconds,
                 "billed duration must be >= 0")
        _require(self.peak_bytes >= 0, "peak_bytes", self.peak_bytes,
                 "peak memory must be >= 0")


def billed_gb_seconds(profile: InvocationProfile,
                      params: ServerlessCostParams = ServerlessCostParams(),
                      ) -> float:
    """GB-seconds the platform bills for one invocation: measured peak
    memory rounded up to the size granularity (floored at the smallest
    purchasable size) times duration rounded up to the billing step —
    a minimum of one step, since a 0 ms invocation still bills one."""
    import math

    mib = profile.peak_bytes / float(1 << 20)
    step = params.memory_step_mib
    billed_mib = max(params.memory_floor_mib, math.ceil(mib / step) * step)
    # Epsilon guards the float division so exact multiples of the step
    # don't round up an extra step (2.0 s at a 1 ms step bills 2000 ms).
    steps = max(1, math.ceil(profile.seconds * 1000.0
                             / params.duration_step_ms - 1e-9))
    billed_s = steps * params.duration_step_ms / 1000.0
    return (billed_mib / 1024.0) * billed_s


def serverless_compute_cost(
    invocations,
    params: ServerlessCostParams = ServerlessCostParams(),
) -> float:
    """The serverless compute leg: sum of billed GB-seconds across the
    run's invocations at the GB-second rate, plus the flat request fee
    per invocation. Re-executed / speculated attempts appear as extra
    invocations and are billed — like VM re-execution traffic, retries
    are real, billed compute."""
    profiles = list(invocations)
    gbs = sum(billed_gb_seconds(p, params) for p in profiles)
    return gbs * params.gb_second + len(profiles) * params.per_invocation


def measured_serverless_tco(
    invocations,
    stats,
    *,
    job_hours: float,
    reduce_hours: float,
    data_bytes: float,
    params: ServerlessCostParams = ServerlessCostParams(),
) -> CostBreakdown:
    """Table 2 with the VM compute row replaced by the measured
    per-invocation GB-second leg.

    Measured vs. assumed follows measured_cloudsort_tco exactly for the
    storage/access legs (same arithmetic via `params.s3`, same
    retry-inflated attempt-count billing basis — `stats` is the sum of
    every invocation's own MetricsMiddleware counters, so a SlowDown'd
    and retried GET bills twice here too). The compute leg is measured
    from each invocation's wall-clock and peak memory; the price sheet
    (`ServerlessCostParams` rates) is assumed.
    """
    base = measured_cloudsort_tco(
        stats, job_hours=job_hours, reduce_hours=reduce_hours,
        data_bytes=data_bytes, params=params.s3)
    return dataclasses.replace(
        base, compute=serverless_compute_cost(invocations, params))


def cluster_tco_at(
    data_tb: float,
    *,
    params: Ec2CostParams = Ec2CostParams(),
    profile: JobProfile = JobProfile(),
    provision_hours: float = 1 / 12,
) -> CostBreakdown:
    """Closed-form VM-cluster TCO at an arbitrary dataset size, for the
    crossover sweep: job time and request counts scale linearly from the
    100 TB profile, but the compute leg has a PROVISIONING FLOOR — a
    cluster bills from boot, and nobody gets a 40-node fleet up, sorted,
    and torn down in under ~`provision_hours` (default 5 minutes)
    however small the dataset. The storage legs use the unfloored scaled
    hours: data sits in S3 for the data's time, not the idle VMs'."""
    _require(data_tb > 0, "data_tb", data_tb, "dataset size must be positive")
    _require(provision_hours >= 0, "provision_hours", provision_hours,
             "the cluster provisioning floor must be >= 0 hours")
    frac = data_tb / 100.0
    job_h = profile.job_hours * frac
    s3_hr = params.s3_hourly_per_100tb() * frac
    return CostBreakdown(
        compute=params.cluster_hourly * max(job_h, provision_hours),
        storage_input=s3_hr * job_h,
        storage_output=s3_hr * profile.reduce_hours * frac,
        access_get=params.get_per_1000 * profile.get_requests * frac / 1000,
        access_put=params.put_per_1000 * profile.put_requests * frac / 1000,
    )


def serverless_tco_at(
    data_tb: float,
    *,
    fn: ServerlessCostParams = ServerlessCostParams(),
    vm_profile: JobProfile = JobProfile(),
) -> CostBreakdown:
    """Closed-form serverless TCO at an arbitrary dataset size: the
    function fleet buys the same GB-hours the paper's VM cluster held
    for the (scaled) job, with NO provisioning floor — functions bill
    per invocation from the first millisecond, which is exactly why
    serverless wins small datasets and loses big ones (the per-GB-second
    rate is ~5.5x the amortized VM rate). Storage/access legs match
    cluster_tco_at so the crossover isolates the compute-meter shape."""
    _require(data_tb > 0, "data_tb", data_tb, "dataset size must be positive")
    frac = data_tb / 100.0
    gb_hours = (fn.equivalent_worker_memory_gb * fn.s3.num_workers
                * vm_profile.job_hours * frac)
    compute = (gb_hours * 3600.0 * fn.gb_second
               + fn.invocations_per_100tb * frac * fn.per_invocation)
    job_h = vm_profile.job_hours * frac
    s3_hr = fn.s3.s3_hourly_per_100tb() * frac
    return CostBreakdown(
        compute=compute,
        storage_input=s3_hr * job_h,
        storage_output=s3_hr * vm_profile.reduce_hours * frac,
        access_get=fn.s3.get_per_1000 * vm_profile.get_requests * frac / 1000,
        access_put=fn.s3.put_per_1000 * vm_profile.put_requests * frac / 1000,
    )


def serverless_crossover_tb(
    *,
    fn: ServerlessCostParams = ServerlessCostParams(),
    vm: Ec2CostParams = Ec2CostParams(),
    profile: JobProfile = JobProfile(),
    provision_hours: float = 1 / 12,
    lo_tb: float = 1e-3,
    hi_tb: float = 1e3,
) -> float:
    """Dataset size (TB) where serverless and cluster TCO cross.

    Below the crossover the cluster's provisioning floor dominates and
    per-invocation billing wins; above it the GB-second premium does.
    Bisection over [lo_tb, hi_tb]; raises ValueError if the gap doesn't
    change sign over the bracket (no crossover under these prices).
    With default parameters the crossover sits just above 1 TB.
    """

    def gap(tb: float) -> float:
        return (serverless_tco_at(tb, fn=fn, vm_profile=profile).total
                - cluster_tco_at(tb, params=vm, profile=profile,
                                 provision_hours=provision_hours).total)

    glo, ghi = gap(lo_tb), gap(hi_tb)
    _require(glo * ghi <= 0, "crossover_bracket", (lo_tb, hi_tb),
             "serverless-vs-cluster cost gap does not change sign over "
             "the bracket — no crossover under these prices")
    for _ in range(200):
        mid = (lo_tb + hi_tb) / 2.0
        if gap(mid) * glo <= 0:
            hi_tb = mid
        else:
            lo_tb = mid
    return (lo_tb + hi_tb) / 2.0


# ---------------------------------------------------------------------------
# H100 re-parameterization (the port's counterpart of the accelerator model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GpuCostParams:
    """A fleet of NVIDIA H100 SXM cards, priced per GPU-hour.

    gpu_hourly: AWS EC2's on-demand list price of a p5.48xlarge (8 x H100
    80GB SXM), $98.32/hr in us-east-1 as listed at its launch (July
    2023), divided by its 8 cards. num_gpus: 40 such instances, the
    paper's 40 workers. hbm_gbps: 3,350 GB/s, the H100 SXM data sheet's
    HBM3 rate. interconnect_gbps: 50 GB/s a card, a p5.48xlarge's 3,200
    Gb/s of EFA network over its 8 cards: the shuffle crosses instances,
    so this, not NVLink's 450 GB/s a direction inside one, bounds it.
    map_records_per_s and reduce_records_per_s: one card's measured
    rates, by default those of chip_smoke.py's full run (2^26 100-byte
    records, map 26.03 s, reduce 29.75 s) on an NVIDIA H100 80GB HBM3 at
    a 700.00 W power limit (PERF.md §5).
    """

    gpu_hourly: float = 98.32 / 8
    num_gpus: int = 320
    hbm_gbps: float = 3350.0
    interconnect_gbps: float = 50.0
    map_records_per_s: float = 2 ** 26 / 26.03
    reduce_records_per_s: float = 2 ** 26 / 29.75
    # Object-store legs unchanged from the paper's S3 model.
    s3: Ec2CostParams = Ec2CostParams()

    def __post_init__(self):
        for knob in ("gpu_hourly", "hbm_gbps", "interconnect_gbps",
                     "map_records_per_s", "reduce_records_per_s"):
            value = getattr(self, knob)
            _require(value > 0, knob, value, "must be positive")
        _require(isinstance(self.num_gpus, int) and self.num_gpus >= 1,
                 "num_gpus", self.num_gpus, "must be a positive int")


def gpu_sort_time_model(
    data_bytes: float,
    p: GpuCostParams = GpuCostParams(),
    *,
    payload_mode: str = "through",
    num_rounds: int = 8,
) -> dict:
    """Job-time estimate for the exoshuffle on a fleet of H100s.

    The roofline terms are the reference's accelerator model's, with the
    interconnect in place of its links. Per-card data share D =
    data_bytes / num_gpus:
      network: the shuffle's all-to-all moves ~D bytes a card over the
               interconnect; "late" mode adds the header shuffle and the
               late payload fetch.
      memory : sort + merge passes over the data in HBM — log2(cards) +
               log2(rounds) merge rounds x 2 (read + write) x bytes in
               flight ("late" mode merges only the 8-byte headers).
    The larger of the two (rounds pipeline them) plus the store's in and
    out legs at the interconnect rate is `t_total_s`.

    `t_measured_s` is the same per-card share of 100-byte records at the
    measured map and reduce rates. `job_hours` takes the larger of the
    two: the roofline is a floor the port does not reach (its map and
    reduce are bound by host work, PERF.md §5), and a job is billed for
    the hours it runs.
    """
    import math

    _require(data_bytes > 0, "data_bytes", data_bytes, "must be positive")
    _require(payload_mode in ("through", "late"), "payload_mode",
             payload_mode, "must be 'through' or 'late'")
    _require(num_rounds >= 1, "num_rounds", num_rounds, "must be >= 1")
    d = data_bytes / p.num_gpus
    hdr_frac = 8.0 / 100.0  # header bytes per 100-byte record
    if payload_mode == "through":
        wire = d
        merge_bytes = d
    else:
        wire = d * hdr_frac + d  # header shuffle + late payload fetch
        merge_bytes = d * hdr_frac
    merge_rounds = math.log2(p.num_gpus) + math.log2(max(num_rounds, 2))
    t_net = wire / (p.interconnect_gbps * 1e9)
    t_mem = merge_bytes * 2 * merge_rounds / (p.hbm_gbps * 1e9)
    t_stage1 = max(t_net, t_mem)
    io_time = d / (p.interconnect_gbps * 1e9)  # store in + out legs
    total = t_stage1 + io_time
    records = d / 100.0
    measured = (records / p.map_records_per_s
                + records / p.reduce_records_per_s)
    return {
        "t_network_s": t_net,
        "t_memory_s": t_mem,
        "t_total_s": total,
        "t_measured_s": measured,
        "job_hours": max(total, measured) / 3600,
    }


def gpu_cloudsort_tco(
    data_bytes: float = 100e12,
    p: GpuCostParams = GpuCostParams(),
    *,
    payload_mode: str = "through",
) -> CostBreakdown:
    """The CloudSort TCO on an H100 fleet: the cards' hours from
    gpu_sort_time_model, and the paper's S3 storage and request legs."""
    t = gpu_sort_time_model(data_bytes, p, payload_mode=payload_mode)
    job_hours = t["job_hours"]
    s3_hr = p.s3.s3_hourly_per_100tb() * (data_bytes / 100e12)
    profile = JobProfile()
    return CostBreakdown(
        compute=p.gpu_hourly * p.num_gpus * job_hours,
        storage_input=s3_hr * job_hours,
        storage_output=s3_hr * job_hours * 0.35,  # reduce-phase fraction
        access_get=p.s3.get_per_1000 * profile.get_requests / 1000,
        access_put=p.s3.put_per_1000 * profile.put_requests / 1000,
    )
