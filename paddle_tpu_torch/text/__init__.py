"""paddle_tpu_torch.text — twin of ``paddle_tpu.text``: the text models
(``GPTModel``, ``BertModel`` and its two heads) and incremental
decoding (``generate``, ``prefill``, the decode-step builders).  The
dataset loaders (``Imdb``, ``WMT14``, ...) wait (ROADMAP item 13)."""
from .generation import (generate, make_gpt_decode_step,  # noqa: F401
                         make_gpt_paged_decode_step, prefill)
from .models import (BertForQuestionAnswering,  # noqa: F401
                     BertForSequenceClassification, BertModel, GPTModel)

__all__ = ["GPTModel", "BertModel", "BertForSequenceClassification",
           "BertForQuestionAnswering", "generate", "prefill",
           "make_gpt_decode_step", "make_gpt_paged_decode_step"]
