"""Typed configuration with the reference's full parameter surface.

Mirrors `fast_limo::Config` (include/fast_limo/Utils/Config.hpp:23-95) and the
ROS param loader (`src/main.cpp:101-168`, defaults preserved), plus a
TPU-specific section (static shape caps, voxel-hash map geometry, mesh
sharding) that has no counterpart in the reference.

YAML profiles in the reference layout (config/kitti.yaml etc.) load directly
via :meth:`Config.from_yaml`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


def _f(v):
    return [float(x) for x in v]


@dataclass
class TopicsConfig:
    lidar: str = "/velodyne_points"
    imu: str = "/EL/Sensors/vectornav/IMU"


@dataclass
class ExtrinsicsConfig:
    # row-major 3x3 rotations & translations, baselink-relative (main.cpp:121-124)
    imu2baselink_t: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    imu2baselink_R: List[float] = field(default_factory=lambda: [1, 0, 0, 0, 1, 0, 0, 0, 1])
    lidar2baselink_t: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    lidar2baselink_R: List[float] = field(default_factory=lambda: [1, 0, 0, 0, 1, 0, 0, 0, 1])


@dataclass
class IntrinsicsConfig:
    accel_bias: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    gyro_bias: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    imu_sm: List[float] = field(default_factory=lambda: [1, 0, 0, 0, 1, 0, 0, 0, 1])


@dataclass
class FiltersConfig:
    crop_active: bool = True
    cropBoxMin: List[float] = field(default_factory=lambda: [-1.0, -1.0, -1.0])
    cropBoxMax: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])
    voxel_active: bool = True
    leafSize: List[float] = field(default_factory=lambda: [0.25, 0.25, 0.25])
    dist_active: bool = False
    min_dist: float = 4.0
    rate_active: bool = False
    rate_value: int = 4
    fov_active: bool = False
    fov_angle: float = math.pi  # HALF FoV in rad (main.cpp:143-146 halves the degree value)


@dataclass
class OctreeConfig:
    # kept with reference names; drives the voxel-hash map geometry
    bucket_size: int = 2
    min_extent: float = 0.2
    downsampling: bool = True


@dataclass
class MappingConfig:
    NUM_MATCH_POINTS: int = 5
    MAX_NUM_MATCHES: int = 2000
    MAX_NUM_PC2MATCH: int = 10000
    MAX_DIST_PLANE: float = 2.0       # gate on kth-NN *squared* distance (Plane.cpp:45-48 w/ Octree sq dists)
    PLANE_THRESHOLD: float = 5.0e-2
    # Robust residual gate for DYNAMIC scenes (no reference counterpart —
    # the reference relies on most points being static, README.md:50-55):
    # reject matches whose |point-to-plane residual| exceeds this multiple
    # of the two-pass robust mean residual (floored at 0.05 m so clean
    # scenes never self-tighten).  Movers leave ~v·Δt ≈ 0.5-1 m residuals
    # against their stale map imprints — far above the static cm-level band
    # — so the gate cuts exactly them.  0 disables (reference-exact).
    DYNAMIC_GATE: float = 4.0
    octree: OctreeConfig = field(default_factory=OctreeConfig)


@dataclass
class IKFoMConfig:
    mapping: MappingConfig = field(default_factory=MappingConfig)
    MAX_NUM_ITERS: int = 3
    LIMITS: float = 1.0e-3            # broadcast to all 23 dims (main.cpp:164-166)
    estimate_extrinsics: bool = True
    cov_gyro: float = 6.0e-4
    cov_acc: float = 1.0e-2
    cov_bias_gyro: float = 1.0e-5
    cov_bias_acc: float = 3.0e-4
    lidar_noise: float = 1.0e-3       # R (Localizer.cpp:333)
    degeneracy_thresh: float = 5.0    # D (Localizer.cpp:333)


@dataclass
class TPUConfig:
    """TPU-native knobs (no reference counterpart): static shapes & map layout."""

    max_points_per_scan: int = 32768      # padded scan size after preprocessing
    map_capacity: int = 2 ** 19           # voxel-hash slots
    map_voxel_size: float = 0.0           # 0 → derived as 2*octree.min_extent
    map_points_per_voxel: int = 0         # 0 → derived from bucket_size (see mapper)
    hash_probes: int = 8                  # max linear probes on lookup
    insert_probes: int = 0                # insert probe budget (0 → hash_probes);
                                          # must be ≤ hash_probes so lookups
                                          # always cover the chains inserts create
    knn_refresh: str = "always"           # RETIRED no-op since round 5: both
                                          # values run the CERTIFIED exact
                                          # re-match (reference semantics —
                                          # re-match every iteration — at
                                          # resolve-once cost; see
                                          # measurement.make_h_model); kept
                                          # so older configs keep loading
    knn_neighborhood: int = 8             # DEPRECATED no-op since the block-
                                          # addressed map (round 4): every value
                                          # resolves to the exact 8-block gather
                                          # (full 27-voxel-cube coverage radius =
                                          # voxel_size from a 4³ superset); kept
                                          # so round-1..3 configs keep loading
    deskew_frames: int = 128              # max propagated states per scan window
    time_sort: bool = False               # time-sort the scan in preprocess
                                          # (the reference's layout; its
                                          # SEQUENTIAL deskew loop needs it).
                                          # The batched pipeline is order-
                                          # invariant end to end (per-point
                                          # frame masks; downsample re-sorts
                                          # by voxel key), so the default
                                          # skips the 32k argsort (~0.6 ms/
                                          # scan on v5e); True restores the
                                          # sorted layout bit-for-bit
    imu_batch: int = 64                   # max IMU samples integrated per scan step
    quantize_transfer: float = 0.0        # >0: ship scan points host→device as
                                          # int16 with this resolution (m/LSB);
                                          # halves the per-scan payload on
                                          # tunneled devices. 0.004 → ±131 m
                                          # range, ≤2 mm rounding (below lidar
                                          # noise). t_raw is scaled per scan;
                                          # requires epoch-relative t_raw
                                          # (always true through Localizer).
    scan_chunk: int = 1                   # scans batched per jitted dispatch
                                          # (>1: offline/replay throughput mode —
                                          # amortizes the fixed per-dispatch cost
                                          # of tunneled/remote accelerators at
                                          # the price of chunk·scan_period
                                          # latency; real-time keeps 1)
    insert_population: str = "full"       # "full" (reference-exact: register +
                                          # insert the WHOLE downsampled cloud,
                                          # Localizer.cpp:358-374 — the
                                          # MAX_NUM_PC2MATCH cap binds matching
                                          # only, Mapper.cpp:63-69) |
                                          # "pc2match" (cap insertion/outputs at
                                          # MAX_NUM_PC2MATCH too — a speed knob;
                                          # thins the map when the downsampled
                                          # scan exceeds the cap)
    max_insert_points: int = 0            # static shape cap on the insert/output
                                          # cloud under insert_population="full"
                                          # (0 → max_points_per_scan). Insert
                                          # cost is SHAPE-driven (sort+scatter
                                          # rows), so runs whose downsampled
                                          # scans stay under a bound can shrink
                                          # this without changing results.
    dtype: str = "float32"
    filter_dtype: str = "float32"         # covariance algebra dtype
    mesh_axes: str = "map"                # device axis name for map sharding
    num_map_shards: int = 1


@dataclass
class ScanContextConfig:
    """ScanContext descriptor geometry (Kim & Kim, IROS 2018).

    Per-profile tunables — a low-mounted Hesai (ONA) or a formula car (CAT)
    need different radii/height shifts than the KITTI roof rig.  The
    descriptor is baked into the jitted scan step, so these are compile-time
    constants per Localizer."""

    n_ring: int = 20
    n_sector: int = 60
    max_radius: float = 80.0
    height_shift: float = 2.0   # added to z so ground returns occupy > 0


@dataclass
class Config:
    topics: TopicsConfig = field(default_factory=TopicsConfig)
    extrinsics: ExtrinsicsConfig = field(default_factory=ExtrinsicsConfig)
    intrinsics: IntrinsicsConfig = field(default_factory=IntrinsicsConfig)
    filters: FiltersConfig = field(default_factory=FiltersConfig)
    ikfom: IKFoMConfig = field(default_factory=IKFoMConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    sc: ScanContextConfig = field(default_factory=ScanContextConfig)

    gravity_align: bool = True
    calibrate_accel: bool = True
    calibrate_gyro: bool = True
    time_offset: bool = True
    end_of_sweep: bool = False

    debug: bool = True
    verbose: bool = True

    sensor_type: int = 1      # 0 OUSTER / 1 VELODYNE / 2 HESAI / 3 LIVOX (Common.hpp:82)
    num_threads: int = 10
    imu_calib_time: float = 3.0
    gravity: float = 9.81     # Localizer ctor gravity_ (Localizer.cpp:25)

    # ---- derived TPU geometry ----
    @property
    def map_voxel_size(self) -> float:
        if self.tpu.map_voxel_size > 0:
            return self.tpu.map_voxel_size
        return 2.0 * self.ikfom.mapping.octree.min_extent

    @property
    def map_points_per_voxel(self) -> int:
        if self.tpu.map_points_per_voxel > 0:
            return self.tpu.map_points_per_voxel
        # octree leaf downsampling keeps > bucket_size/8 points out at min
        # extent (Octree.hpp:399-401); with default bucket_size=2 that is one
        # point per finest leaf. Keep at least 1.
        return max(1, self.ikfom.mapping.octree.bucket_size // 8 + 1)

    # ---- loading ----
    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        if yaml is None:
            raise RuntimeError("pyyaml not available")
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()

        def get(*keys, default=None):
            cur = d
            for k in keys:
                if not isinstance(cur, dict) or k not in cur:
                    return default
                cur = cur[k]
            return cur

        cfg.topics.lidar = get("topics", "input", "lidar", default=cfg.topics.lidar)
        cfg.topics.imu = get("topics", "input", "imu", default=cfg.topics.imu)
        cfg.num_threads = int(get("num_threads", default=cfg.num_threads))
        cfg.sensor_type = int(get("sensor_type", default=cfg.sensor_type))
        cfg.debug = bool(get("debug", default=cfg.debug))
        cfg.verbose = bool(get("verbose", default=cfg.verbose))
        cfg.ikfom.estimate_extrinsics = bool(get("estimate_extrinsics", default=cfg.ikfom.estimate_extrinsics))
        cfg.time_offset = bool(get("time_offset", default=cfg.time_offset))
        cfg.end_of_sweep = bool(get("end_of_sweep", default=cfg.end_of_sweep))

        cfg.gravity_align = bool(get("calibration", "gravity_align", default=cfg.gravity_align))
        cfg.calibrate_accel = bool(get("calibration", "accel", default=cfg.calibrate_accel))
        cfg.calibrate_gyro = bool(get("calibration", "gyro", default=cfg.calibrate_gyro))
        cfg.imu_calib_time = float(get("calibration", "time", default=cfg.imu_calib_time))

        ext = cfg.extrinsics
        ext.imu2baselink_t = _f(get("extrinsics", "imu", "t", default=ext.imu2baselink_t))
        ext.imu2baselink_R = _f(get("extrinsics", "imu", "R", default=ext.imu2baselink_R))
        ext.lidar2baselink_t = _f(get("extrinsics", "lidar", "t", default=ext.lidar2baselink_t))
        ext.lidar2baselink_R = _f(get("extrinsics", "lidar", "R", default=ext.lidar2baselink_R))

        intr = cfg.intrinsics
        intr.accel_bias = _f(get("intrinsics", "accel", "bias", default=intr.accel_bias))
        intr.gyro_bias = _f(get("intrinsics", "gyro", "bias", default=intr.gyro_bias))
        intr.imu_sm = _f(get("intrinsics", "accel", "sm", default=intr.imu_sm))

        fl = cfg.filters
        fl.crop_active = bool(get("filters", "cropBox", "active", default=fl.crop_active))
        fl.cropBoxMin = _f(get("filters", "cropBox", "box", "min", default=fl.cropBoxMin))
        fl.cropBoxMax = _f(get("filters", "cropBox", "box", "max", default=fl.cropBoxMax))
        fl.voxel_active = bool(get("filters", "voxelGrid", "active", default=fl.voxel_active))
        fl.leafSize = _f(get("filters", "voxelGrid", "leafSize", default=fl.leafSize))
        fl.dist_active = bool(get("filters", "minDistance", "active", default=fl.dist_active))
        fl.min_dist = float(get("filters", "minDistance", "value", default=fl.min_dist))
        fl.rate_active = bool(get("filters", "rateSampling", "active", default=fl.rate_active))
        fl.rate_value = int(get("filters", "rateSampling", "value", default=fl.rate_value))
        fl.fov_active = bool(get("filters", "FoV", "active", default=fl.fov_active))
        fov_deg = float(get("filters", "FoV", "value", default=360.0))
        fl.fov_angle = fov_deg * math.pi / 360.0  # half-FoV (main.cpp:143-146)

        ik = cfg.ikfom
        ik.MAX_NUM_ITERS = int(get("iKFoM", "MAX_NUM_ITERS", default=ik.MAX_NUM_ITERS))
        ik.mapping.MAX_NUM_MATCHES = int(get("iKFoM", "MAX_NUM_MATCHES", default=ik.mapping.MAX_NUM_MATCHES))
        ik.mapping.MAX_NUM_PC2MATCH = int(float(get("iKFoM", "MAX_NUM_PC2MATCH", default=ik.mapping.MAX_NUM_PC2MATCH)))
        ik.LIMITS = float(get("iKFoM", "LIMITS", default=ik.LIMITS))
        ik.mapping.NUM_MATCH_POINTS = int(get("iKFoM", "Mapping", "NUM_MATCH_POINTS", default=ik.mapping.NUM_MATCH_POINTS))
        ik.mapping.MAX_DIST_PLANE = float(get("iKFoM", "Mapping", "MAX_DIST_PLANE", default=ik.mapping.MAX_DIST_PLANE))
        ik.mapping.PLANE_THRESHOLD = float(get("iKFoM", "Mapping", "PLANES_THRESHOLD", default=ik.mapping.PLANE_THRESHOLD))
        ik.mapping.octree.bucket_size = int(get("iKFoM", "Mapping", "Octree", "bucket_size", default=ik.mapping.octree.bucket_size))
        ik.mapping.octree.min_extent = float(get("iKFoM", "Mapping", "Octree", "min_extent", default=ik.mapping.octree.min_extent))
        ik.mapping.octree.downsampling = bool(get("iKFoM", "Mapping", "Octree", "downsampling", default=ik.mapping.octree.downsampling))
        ik.cov_gyro = float(get("iKFoM", "covariance", "gyro", default=ik.cov_gyro))
        ik.cov_acc = float(get("iKFoM", "covariance", "accel", default=ik.cov_acc))
        ik.cov_bias_gyro = float(get("iKFoM", "covariance", "bias_gyro", default=ik.cov_bias_gyro))
        ik.cov_bias_acc = float(get("iKFoM", "covariance", "bias_accel", default=ik.cov_bias_acc))

        tpu = get("tpu", default=None)
        if isinstance(tpu, dict):
            for k, v in tpu.items():
                if hasattr(cfg.tpu, k):
                    setattr(cfg.tpu, k, type(getattr(cfg.tpu, k))(v))
        sc = get("scancontext", default=None)
        if isinstance(sc, dict):
            for k, v in sc.items():
                if hasattr(cfg.sc, k):
                    setattr(cfg.sc, k, type(getattr(cfg.sc, k))(v))
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
