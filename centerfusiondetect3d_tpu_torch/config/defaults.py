"""Default configuration schema.

The same keys as ``centerfusiondetect3d_tpu/config/defaults.py``, so that every
YAML under ``configs/`` and every dotted override loads unchanged.

``MIXED_PRECISION`` (default true, as in every shipped config) is honoured as
the JAX package honours it: ``models/detector.py:build_model`` makes a model
that computes in bfloat16 with float32 parameters, BatchNorm statistics and
head outputs, serves through the bf16 DCN forward kernel and, in
``runtime/fit.py``'s Trainer, trains through the bf16 DCN backward kernels;
set it false to train (or to serve) in float32.

The port always computes the exact ops, so the keys that select a TPU
approximation or a TPU runtime setting are accepted and ignored:

- ``MODEL.DLA.DCN_IMPL``, ``DCN_DEEP_IMPL``, ``DCN_DEEP_MIN_CH``,
  ``DCN_MAX_OFFSET``, ``DCN_CORRECT_FRAC``, ``DCN_CORRECT_APPROX`` and
  ``S2D_STEM``: every DCN node runs the unclamped op on the plain stem;
- ``MODEL.APPROX_TOPK`` and ``MODEL.FUSED_HEAD_TOWERS``: top-k is exact and
  every head tower runs on its own;
- ``TEST.MAX_DEVICE_BATCH``, ``TEST.DEVICE_BATCH_MAP`` and every ``TPU.*``
  key but two.

``runtime/fit.py``'s Trainer reads ``TPU.PREFETCH`` (the batches that
``data/pipeline.py:device_prefetch`` moves to the device ahead of the
step) and ``TPU.PROFILE`` (a ``torch.profiler`` trace of the first epoch
into ``OUTPUT_DIR/profile``), and ``WORKERS`` (the Loader's threads; 0
builds the items on the training thread, the fastest setting measured for
the eager step, ``PERF.md`` §7).
"""

from .node import ConfigNode


def default_config() -> ConfigNode:
    c = ConfigNode()
    c.NAME = "CenterFusion"
    c.OUTPUT_DIR = "output"

    c.GPUS = (0,)
    c.WORKERS = 2
    c.DEBUG = 0
    c.EVAL = False
    c.RANDOM_SEED = 0
    c.MIXED_PRECISION = True  # bf16 compute, float32 parameters
    c.CONF_THRESH = 0.3
    c.WANDB_RESUME = False
    c.WANDB_RESUBMIT = False

    c.DATASET = ConfigNode()
    c.DATASET.DATASET = "nuscenes"
    c.DATASET.ROOT = "data/"
    c.DATASET.RANDOM_CROP = False
    c.DATASET.MAX_CROP = True
    c.DATASET.SHIFT = 0.2
    c.DATASET.SCALE = 0.0
    c.DATASET.ROTATE = 0.0
    c.DATASET.FLIP = 0.5
    c.DATASET.COLOR_AUG = True
    c.DATASET.TRAIN_SPLIT = "train"
    c.DATASET.VAL_SPLIT = "mini_val"
    c.DATASET.RADAR_PC = True
    c.DATASET.MAX_PC = 1000
    c.DATASET.MAX_PC_DIST = 60.0
    c.DATASET.PC_Z_OFFSET = 0.0
    c.DATASET.PC_ROI_METHOD = "pillars"  # pillars | heatmap | points
    c.DATASET.PILLAR_DIMS = (1.5, 0.2, 0.2)
    c.DATASET.ONE_HOT_PC = False
    c.DATASET.DECOUPLE_REP = False
    c.DATASET.HEATMAP_REP = "2d"  # 2d | 3d

    c.MODEL = ConfigNode()
    c.MODEL.LOAD_DIR = ""
    c.MODEL.ARCH = "dla_34"
    c.MODEL.FREEZE_BACKBONE = False
    c.MODEL.NORM_EVAL = False
    c.MODEL.NORM_2D = False
    c.MODEL.DEFREEZE = -1
    c.MODEL.FUSION_STRATEGY = "middle"  # early | middle | None
    c.MODEL.FRUSTUM = True
    c.MODEL.K = 100
    c.MODEL.FUSED_HEAD_TOWERS = False  # ignored
    c.MODEL.APPROX_TOPK = True  # ignored: top-k is exact
    c.MODEL.INPUT_SIZE = (448, 800)
    c.MODEL.DLA = ConfigNode()
    c.MODEL.DLA.NODE = "DeformConv"  # DeformConv | GlobalConv | Conv
    c.MODEL.DLA.DCN_IMPL = "auto"  # ignored: DCN is always exact
    c.MODEL.DLA.DCN_MAX_OFFSET = 1.0  # ignored
    c.MODEL.DLA.DCN_CORRECT_FRAC = 0.03  # ignored
    c.MODEL.DLA.DCN_CORRECT_APPROX = True  # ignored
    c.MODEL.DLA.S2D_STEM = True  # ignored: the plain stem is the same math
    c.MODEL.DLA.DCN_DEEP_IMPL = "shift_hybrid"  # ignored
    c.MODEL.DLA.DCN_DEEP_MIN_CH = 256  # ignored

    c.LOSS_WEIGHTS = ConfigNode()
    c.LOSS_WEIGHTS.HEATMAP = 1.0
    c.LOSS_WEIGHTS.AMODAL_OFFSET = 1.0
    c.LOSS_WEIGHTS.DIMENSION_2D = 0.1
    c.LOSS_WEIGHTS.DEPTH = 1.0
    c.LOSS_WEIGHTS.DIMENSION_3D = 1.0
    c.LOSS_WEIGHTS.ROTATION = 1.0
    c.LOSS_WEIGHTS.NUSCENES_ATT = 1.0
    c.LOSS_WEIGHTS.VELOCITY = 1.0
    c.LOSS_WEIGHTS.BBOX_2D = 0.0
    c.LOSS_WEIGHTS.BBOX_3D = 0.0
    c.LOSS_WEIGHTS.LIDAR_DEPTH = 0.0
    c.LOSS_WEIGHTS.RADAR_DEPTH = 0.0

    c.TRAIN = ConfigNode()
    c.TRAIN.BATCH_SIZE = 26
    c.TRAIN.SHUFFLE = True
    c.TRAIN.EPOCHS = 60
    c.TRAIN.WARM_EPOCHS = 5
    c.TRAIN.RESUME = False
    c.TRAIN.OPTIMIZER = "adam"
    c.TRAIN.LR = 2.5e-4
    c.TRAIN.LR_STEP = (50,)
    c.TRAIN.SAVE_INTERVALS = 10
    c.TRAIN.VAL_INTERVALS = 10
    c.TRAIN.SCALE_FACTOR = 16
    c.TRAIN.LR_SCHEDULER = "StepLR"  # CLR | StepLR
    c.TRAIN.UNCERTAINTY_LOSS = False
    c.TRAIN.GRAD_ACCUM = 1
    c.TRAIN.NONFINITE_TOLERANCE = 5

    c.TEST = ConfigNode()
    c.TEST.BATCH_SIZE = 1
    c.TEST.OFFICIAL_EVAL = False
    c.TEST.FLIP_TEST = False  # flip TTA (Detector, Trainer.val)
    c.TEST.MULTI_SCALE = ()  # multi-scale TTA (Detector.run)
    c.TEST.FAST_DECODE = True
    c.TEST.MAX_DEVICE_BATCH = 6  # ignored
    c.TEST.DEVICE_BATCH_MAP = True  # ignored
    # serving path: paint the radar depth map on the device from compact
    # per-point (box, value) rows instead of shipping the dense raster;
    # bit-identical to the host paint. The host raster stays in use for
    # ONE_HOT_PC and when a camera has more than MAX_PC points.
    c.TEST.DEVICE_RASTERIZE = True

    # accepted so that every YAML loads; ignored by the port
    c.TPU = ConfigNode()
    c.TPU.MESH_DATA = -1
    c.TPU.MESH_MODEL = 1
    c.TPU.MESH_SPATIAL = 1
    c.TPU.PREFETCH = 2
    c.TPU.DONATE = True
    c.TPU.PLATFORM = ""
    c.TPU.DEBUG_NANS = False
    c.TPU.PROFILE = False
    c.TPU.REMAT = False
    return c
