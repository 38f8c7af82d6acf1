from progen_tpu_torch.data.tfrecord import (
    collate,
    count_sequences,
    iterator_from_tfrecords_folder,
    shard_filename,
    write_tfrecord,
)
from progen_tpu_torch.data.tokenizer import (
    OFFSET,
    PAD_ID,
    VOCAB_SIZE,
    decode_tokens,
    encode_tokens,
)

__all__ = ["OFFSET", "PAD_ID", "VOCAB_SIZE", "collate", "count_sequences",
           "decode_tokens", "encode_tokens", "iterator_from_tfrecords_folder",
           "shard_filename", "write_tfrecord"]
