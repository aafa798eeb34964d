"""The baseline model families (port of
emotiongestures_tpu/models/baselines/): seq2seq, speech2gesture, trimodal,
hierarchy, the embedding net and the motion autoencoder. They run on
cuDNN and cuBLAS through torch.nn; no Pallas kernel of the JAX package
reaches them."""
from .embedding_net import EmbeddingNet, PoseEncoderConv  # noqa: F401
from .hierarchy import (  # noqa: F401
    HierarchicalConvDiscriminator,
    HierarchicalDiscriminator,
    HierarchicalPoseGenerator,
    HierarchicalWavEncoder,
)
from .motion_ae import MotionAE  # noqa: F401
from .seq2seq import Seq2SeqNet  # noqa: F401
from .speech2gesture import S2GDiscriminator, S2GGenerator  # noqa: F401
from .trimodal import (  # noqa: F401
    ConvDiscriminator,
    PoseGenerator,
    TextEncoderTCN32,
    TrimodalDiscriminator,
    WavEncoder,
)
