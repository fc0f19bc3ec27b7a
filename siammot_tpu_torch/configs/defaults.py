"""Default configuration: own copy of the ``siammot_tpu.configs.defaults``
keys that the inference and training slices read, with the same names
and values, so
the JAX package's YAML overlays and ``merge_from_list`` options apply
unchanged.  ``TPU.*`` keeps its name for that reason; on the card it
holds the same static capacities and dtypes.
"""

from .node import CfgNode as CN

_C = CN()

_C.MODEL = CN()
# tools/train_net's initial weights when the run has no checkpoint: a
# reference .pth, a port checkpoint (file or directory) or a flax .npz
_C.MODEL.WEIGHT = ""
# read by utils/model_name.py (the run directory's name)
_C.MODEL.BOX_ON = True
_C.MODEL.TRACK_ON = True
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "DLA-34-FPN"
# ResNet bodies: freeze the stem (at >= 1) and layer1..layer{at-1} in the
# optimizer (engine/solver.py:make_optimizer); DLA bodies ignore it
_C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 0

_C.MODEL.DLA = CN()
_C.MODEL.DLA.DLA_STAGE2_OUT_CHANNELS = 64
_C.MODEL.DLA.DLA_STAGE3_OUT_CHANNELS = 128
_C.MODEL.DLA.DLA_STAGE4_OUT_CHANNELS = 256
_C.MODEL.DLA.DLA_STAGE5_OUT_CHANNELS = 512
_C.MODEL.DLA.BACKBONE_OUT_CHANNELS = 128
_C.MODEL.DLA.STAGE_WITH_DCN = (False, False, False, False, False, False)

# ResNet bodies (CONV_BODY "R-50-FPN", "R-101-FPN", "R-152-FPN";
# maskrcnn-benchmark's MODEL.RESNETS defaults, Caffe2 conventions)
_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STAGE_WITH_DCN = (False, False, False, False)

_C.MODEL.RPN = CN()
_C.MODEL.RPN.ANCHOR_STRIDE = (4, 8, 16, 32, 64)
_C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 1000
_C.MODEL.RPN.POST_NMS_TOP_N_TEST = 300
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 300
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.MIN_SIZE = 0
_C.MODEL.RPN.STRADDLE_THRESH = 0
_C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
_C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.FPN_POST_NMS_PER_BATCH = True

_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_HEADS.SCORE_THRESH = 0.05
_C.MODEL.ROI_HEADS.NMS = 0.5
_C.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
_C.MODEL.ROI_BOX_HEAD.POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
_C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 2
_C.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 1024

_C.MODEL.TRACK_HEAD = CN()
_C.MODEL.TRACK_HEAD.TRACKTOR = False
_C.MODEL.TRACK_HEAD.MODEL = "EMM"
_C.MODEL.TRACK_HEAD.POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)
_C.MODEL.TRACK_HEAD.POOLER_RESOLUTION = 15
_C.MODEL.TRACK_HEAD.POOLER_SAMPLING_RATIO = 2
_C.MODEL.TRACK_HEAD.PAD_PIXELS = 512
_C.MODEL.TRACK_HEAD.SEARCH_REGION = 2.0
_C.MODEL.TRACK_HEAD.MINIMUM_SREACH_REGION = 0
_C.MODEL.TRACK_HEAD.TRACK_THRESH = 0.4
_C.MODEL.TRACK_HEAD.START_TRACK_THRESH = 0.6
_C.MODEL.TRACK_HEAD.RESUME_TRACK_THRESH = 0.4
_C.MODEL.TRACK_HEAD.MAX_DORMANT_FRAMES = 1
_C.MODEL.TRACK_HEAD.PROPOSAL_PER_IMAGE = 256
_C.MODEL.TRACK_HEAD.FG_IOU_THRESHOLD = 0.65
_C.MODEL.TRACK_HEAD.BG_IOU_THRESHOLD = 0.35
_C.MODEL.TRACK_HEAD.EMM = CN()
_C.MODEL.TRACK_HEAD.EMM.USE_CENTERNESS = True
_C.MODEL.TRACK_HEAD.EMM.COSINE_WINDOW_WEIGHT = 0.4
_C.MODEL.TRACK_HEAD.EMM.POS_RATIO = 0.25
_C.MODEL.TRACK_HEAD.EMM.HN_RATIO = 0.25
_C.MODEL.TRACK_HEAD.EMM.TRACK_LOSS_WEIGHT = 1.0
_C.MODEL.TRACK_HEAD.EMM.CLS_POS_REGION = 0.8

_C.INPUT = CN()
# training augmentation (data/augmentation.py:build_siam_augmentation)
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.BRIGHTNESS = 0.0
_C.INPUT.CONTRAST = 0.0
_C.INPUT.SATURATION = 0.0
_C.INPUT.HUE = 0.0
_C.INPUT.HORIZONTAL_FLIP_PROB_TRAIN = 0.5
_C.INPUT.MOTION_LIMIT = 0.1
_C.INPUT.COMPRESSION_LIMIT = 50
_C.INPUT.MOTION_BLUR_PROB = 0.5
# test-time resize: short side to MIN_SIZE_TEST unless the long side
# would pass MAX_SIZE_TEST (resize_dims)
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.PIXEL_MEAN = (0.485, 0.456, 0.406)
_C.INPUT.PIXEL_STD = (0.229, 0.224, 0.225)
_C.INPUT.TO_BGR255 = False
_C.INPUT.AMODAL = False

# training clips (data/datasets.py:VideoDataset): window and stride in ms
_C.VIDEO = CN()
_C.VIDEO.TEMPORAL_WINDOW = 8
_C.VIDEO.TEMPORAL_SAMPLING = 4
_C.VIDEO.RANDOM_FRAMES_PER_CLIP = 2

_C.INFERENCE = CN()
# MOT17 public-detection mode: the given detections replace the RPN's
# proposals (engine/inferencer.py:track_frames needs them then)
_C.INFERENCE.USE_GIVEN_DETECTIONS = False
_C.INFERENCE.CLIP_LEN = 1

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.SIZE_DIVISIBILITY = 32
_C.DATALOADER.ASPECT_RATIO_GROUPING = False

# dataset keys of data/dataset_info.py, under ROOT_DIR
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()
_C.DATASETS.ROOT_DIR = ""

_C.OUTPUT_DIR = "."

_C.SOLVER = CN()
_C.SOLVER.BASE_LR = 0.02
_C.SOLVER.BIAS_LR_FACTOR = 2
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_BIAS = 0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000, 40000)
_C.SOLVER.MAX_ITER = 50000
_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.VIDEO_CLIPS_PER_BATCH = 16
# each global batch as N sequential microbatches with averaged gradients
# (one optimizer/LR step per batch)
_C.SOLVER.ACCUMULATION_STEPS = 1

_C.TPU = CN()
# padded track-slot capacity (active + dormant tracks per stream)
_C.TPU.MAX_TRACKS = 128
# dtype of the conv trunk, the heads and the EMM predictor
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# dtype of the stacked FPN table the window pool reads at inference
# (training always packs an f32 table)
_C.TPU.POOLER_DTYPE = "bfloat16"
# the JAX package's padded detection capacity; neither package's step
# reads it, it is here so that options naming it apply
_C.TPU.MAX_DETECTIONS = 256
# ship raw uint8 frames and normalise them on the device
# (models/siammot.normalize_images); False normalises on the host
# (data/transforms.EvalTransform)
_C.TPU.DEVICE_NORMALIZE = True
# padded ground-truth capacity per training frame
_C.TPU.MAX_GT = 100
# static training input (H, W) the collator pads every batch to; 0 pads
# to the batch's own size-divisible extent
_C.TPU.INPUT_HEIGHT = 0
_C.TPU.INPUT_WIDTH = 0
# the JAX package's data-parallel mesh size; the port trains on one card
# (0 or 1)
_C.TPU.DATA_PARALLEL = 0
# per-site window sizes of the windowed pool (feature px, rows == cols)
_C.TPU.WINDOW_BOX = 64
_C.TPU.WINDOW_TEMPLATE = 64
_C.TPU.WINDOW_SR = 128
# space-to-depth DLA stem; False runs the plain stem (base 7x7, level0,
# level1), the reference .pth's layout, which exports exactly
_C.TPU.S2D_STEM = True
# the JAX package's im2col matmul form of these DLA/ResNet stages' 3x3
# convolutions, exact on the same parameters; the port runs the same
# convolutions either way (models/siammot.py)
_C.TPU.CONV_MATMUL_STAGES = ()
# kernel toggles of the JAX package, all accepted: USE_PALLAS False runs
# the EMM head over every slot and the XLA decode (torch ops), as does
# DECODE_PALLAS False for the decode; POOLER_WINDOWED and
# TRAIN_POOLER_WINDOWED False pool with the exact gather pooler
# (ops/roi_align.py) at inference and in training; MASKED_TRACK_KERNELS
# False runs the unmasked EMM route
_C.TPU.USE_PALLAS = True
_C.TPU.POOLER_WINDOWED = True
_C.TPU.DECODE_PALLAS = True
_C.TPU.MASKED_TRACK_KERNELS = True
_C.TPU.TRAIN_POOLER_WINDOWED = True
# recompute the trunk (body + FPN) in the training backward instead of
# keeping its activations (torch.utils.checkpoint)
_C.TPU.REMAT = False


def get_cfg() -> CN:
    """Return a fresh clone of the default config."""
    return _C.clone()


def resize_dims(w: int, h: int, min_size: int, max_size: int):
    """The test-time resize of a (w, h) frame (maskrcnn Resize.get_size,
    own copy of ``siammot_tpu/data/transforms.py:resize_dims``): returns
    (new_w, new_h)."""
    mn, mx = min(w, h), max(w, h)
    size = min_size
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if mn == size:
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


# stage widths of the Bottleneck DLA bodies (DLA_STAGE2..5_OUT_CHANNELS),
# which take deformable stages
DLA_STAGE_WIDTHS = {"DLA-46-C-FPN": (64, 64, 128, 256),
                    "DLA-46-XC-FPN": (64, 64, 128, 256),
                    "DLA-60-FPN": (128, 256, 512, 1024),
                    "DLA-102-FPN": (128, 256, 512, 1024),
                    "DLA-169-FPN": (128, 256, 512, 1024)}


# and of the Res2Net body, which takes none
RES2NET_STAGE_WIDTHS = {"DLA-60-RES2NET-FPN": (128, 256, 512, 1024)}


def dla_body_overrides(body: str) -> list:
    """``merge_from_list`` options that select a Bottleneck or Res2Net DLA
    body with its stage widths."""
    opts = ["MODEL.BACKBONE.CONV_BODY", body]
    widths = {**DLA_STAGE_WIDTHS, **RES2NET_STAGE_WIDTHS}[body]
    for i, c in zip((2, 3, 4, 5), widths):
        opts += [f"MODEL.DLA.DLA_STAGE{i}_OUT_CHANNELS", c]
    return opts


def dla_dcn_overrides(body: str) -> list:
    """``merge_from_list`` options of a model-zoo ``<body>-DCN`` detector
    as ``tools/bench_variants.py:make_cfg`` builds it: the body, its stage
    widths and deformable 3x3s on stages 3-5."""
    return dla_body_overrides(body) + [
        "MODEL.DLA.STAGE_WITH_DCN", (False, False, False, True, True, True)]
