from agacs_tpu_torch.text.tokenizer import (  # noqa: F401
    LANGUAGES,
    SpecialTokens,
    WhisperTokenizer,
    WhisperTokenIdConverter,
)
from agacs_tpu_torch.text.cleaner import BasicTextNormalizer, TextCleaner  # noqa: F401
