"""Tree checkpointing (.npz + JSON manifest, atomic publish), in the
reference's on-disk layout."""

from repro_torch.checkpoint.io import (
    load_checkpoint, load_extra_arrays, load_manifest, read_pointer,
    save_checkpoint, write_pointer,
)

__all__ = ["load_checkpoint", "load_extra_arrays", "load_manifest",
           "read_pointer", "save_checkpoint", "write_pointer"]
