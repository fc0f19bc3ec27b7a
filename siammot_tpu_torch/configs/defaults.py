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
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "DLA-34-FPN"

_C.MODEL.DLA = CN()
_C.MODEL.DLA.DLA_STAGE2_OUT_CHANNELS = 64
_C.MODEL.DLA.DLA_STAGE3_OUT_CHANNELS = 128
_C.MODEL.DLA.DLA_STAGE4_OUT_CHANNELS = 256
_C.MODEL.DLA.DLA_STAGE5_OUT_CHANNELS = 512
_C.MODEL.DLA.BACKBONE_OUT_CHANNELS = 128
_C.MODEL.DLA.STAGE_WITH_DCN = (False, False, False, False, False, False)

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
# test-time resize: short side to MIN_SIZE_TEST unless the long side
# would pass MAX_SIZE_TEST (resize_dims)
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.PIXEL_MEAN = (0.485, 0.456, 0.406)
_C.INPUT.PIXEL_STD = (0.229, 0.224, 0.225)
_C.INPUT.TO_BGR255 = False
_C.INPUT.AMODAL = False

_C.INFERENCE = CN()
# MOT17 public-detection mode: the given detections replace the RPN's
# proposals (engine/inferencer.py:track_frames needs them then)
_C.INFERENCE.USE_GIVEN_DETECTIONS = False
_C.INFERENCE.CLIP_LEN = 1

_C.DATALOADER = CN()
_C.DATALOADER.SIZE_DIVISIBILITY = 32

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
# padded ground-truth capacity per training frame
_C.TPU.MAX_GT = 100
# per-site window sizes of the windowed pool (feature px, rows == cols)
_C.TPU.WINDOW_BOX = 64
_C.TPU.WINDOW_TEMPLATE = 64
_C.TPU.WINDOW_SR = 128
# space-to-depth DLA stem (the only stem the port runs)
_C.TPU.S2D_STEM = True
# kernel toggles of the JAX package; the port rejects USE_PALLAS,
# POOLER_WINDOWED, DECODE_PALLAS and S2D_STEM False (the JAX package's
# XLA forms), runs MASKED_TRACK_KERNELS False (the unmasked EMM route)
# and TRAIN_POOLER_WINDOWED False outside training
_C.TPU.USE_PALLAS = True
_C.TPU.POOLER_WINDOWED = True
_C.TPU.DECODE_PALLAS = True
_C.TPU.MASKED_TRACK_KERNELS = True
_C.TPU.TRAIN_POOLER_WINDOWED = True
# rematerialised backbone in the training backward (not ported: must stay
# False)
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


# stage widths of the Bottleneck DLA bodies (DLA_STAGE2..5_OUT_CHANNELS)
DLA_STAGE_WIDTHS = {"DLA-46-C-FPN": (64, 64, 128, 256),
                    "DLA-46-XC-FPN": (64, 64, 128, 256),
                    "DLA-60-FPN": (128, 256, 512, 1024),
                    "DLA-102-FPN": (128, 256, 512, 1024),
                    "DLA-169-FPN": (128, 256, 512, 1024)}


def dla_dcn_overrides(body: str) -> list:
    """``merge_from_list`` options of a model-zoo ``<body>-DCN`` detector
    as ``tools/bench_variants.py:make_cfg`` builds it: the body, its stage
    widths and deformable 3x3s on stages 3-5."""
    opts = ["MODEL.BACKBONE.CONV_BODY", body, "MODEL.DLA.STAGE_WITH_DCN",
            (False, False, False, True, True, True)]
    for i, c in zip((2, 3, 4, 5), DLA_STAGE_WIDTHS[body]):
        opts += [f"MODEL.DLA.DLA_STAGE{i}_OUT_CHANNELS", c]
    return opts
