"""paddle_tpu_torch.nn — the paddle layer API (twins of ``paddle_tpu/nn``
under the same names): ``Layer`` and the initializers; the common layers
of ``nn.common_layers`` (``Linear``, ``Embedding``, the dropouts,
``Upsample``, the pads and shuffles, ``Bilinear``, ``Fold``, ...); the
activation, convolution, norm and pooling layers; the containers
``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``; the
recurrent layers of ``nn.rnn``; the transformer stack of
``nn.transformer``; the decoding loops of ``nn.decode`` (beam search,
``dynamic_decode``, greedy; ``Decoder`` is ``BeamSearchDecoder``, its
reference's only concrete form); the loss layers of ``nn.loss_layers``,
the gradient clips of ``nn.clip_grad`` and ``nn.layers_extra``
(``PairwiseDistance``, ``HSigmoidLoss``, ``NCELoss``, ``TreeConv``,
``ctc_greedy_decoder``, ``DynamicRNN`` / ``StaticRNN``).  The functional
submodules are re-exported under the reference's names: ``common``
(``nn.functional``), ``conv``, ``extension``, ``loss``, ``norm`` and
``weight_norm_hook`` (``norm``); ``cond`` and ``while_loop`` are
``jit.control_flow``'s, ``Input`` is ``InputSpec``.  ``crf_decoding``
and ``vision`` wait for ROADMAP item 13.
"""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import activation_layers as _activation_layers
from . import conv_layers as _conv_layers
from . import norm_layers as _norm_layers
from . import pool_layers as _pool_layers
from .activation_layers import *  # noqa: F401,F403
from .clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                        ClipGradByValue)
from . import common_layers as _common_layers
from .common_layers import *  # noqa: F401,F403
from .container import (LayerDict, LayerList, ParameterList,  # noqa: F401
                        Sequential)
from .conv_layers import *  # noqa: F401,F403
from .decode import (BeamSearchDecoder, beam_search_decode,  # noqa: F401
                     beam_search_step, dynamic_decode, gather_tree,
                     greedy_search_decode)
from .layer import Layer, state_from_numpy  # noqa: F401
from .loss_layers import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                          CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
                          HingeEmbeddingLoss, KLDivLoss, L1Loss,
                          MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                          TripletMarginLoss)
from .norm_layers import *  # noqa: F401,F403
from .pool_layers import *  # noqa: F401,F403
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .layers_extra import (DynamicRNN, HSigmoidLoss, NCELoss,  # noqa: F401
                           PairwiseDistance, StaticRNN, TreeConv,
                           ctc_greedy_decoder)
from .decode import BeamSearchDecoder as Decoder  # noqa: F401
from ..jit.control_flow import cond, while_loop  # noqa: F401
from ..jit.to_static import InputSpec as Input  # noqa: F401
from . import functional as common  # noqa: F401
from .functional import conv, extension, loss, norm  # noqa: F401
weight_norm_hook = norm

__all__ = ["Layer", "Sequential", "LayerList", "ParameterList",
           "LayerDict", "RNNCellBase",
           "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "GRU", "LSTM", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "BeamSearchDecoder", "beam_search_decode", "beam_search_step",
           "dynamic_decode", "gather_tree", "greedy_search_decode",
           "state_from_numpy", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "CrossEntropyLoss", "MSELoss", "L1Loss",
           "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "SmoothL1Loss", "MarginRankingLoss", "CTCLoss",
           "HingeEmbeddingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
           "PairwiseDistance", "HSigmoidLoss", "NCELoss", "TreeConv",
           "ctc_greedy_decoder", "DynamicRNN", "StaticRNN", "Decoder"] + \
    (_common_layers.__all__ + _activation_layers.__all__
     + _conv_layers.__all__ + _norm_layers.__all__ + _pool_layers.__all__)
