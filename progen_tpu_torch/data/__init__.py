from progen_tpu_torch.data.tokenizer import (
    OFFSET,
    PAD_ID,
    VOCAB_SIZE,
    decode_tokens,
    encode_tokens,
)

__all__ = ["OFFSET", "PAD_ID", "VOCAB_SIZE", "decode_tokens", "encode_tokens"]
