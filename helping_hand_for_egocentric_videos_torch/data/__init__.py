from .egtea import EgteaConfig, EgteaDataset, generate_label_map
from .epic import EpicConfig, EpicMIRDataset, datetime2sec
from .loader import PrefetchLoader, ShardedSampler, collate, prepare_train_batch
from .samplers import get_frame_ids, sample_frames, sample_frames_clips, sample_frames_start_end
from .tokenizer import CONTEXT_LENGTH, VOCAB_SIZE, ClipTokenizer

__all__ = [
    "ClipTokenizer",
    "CONTEXT_LENGTH",
    "EgteaConfig",
    "EgteaDataset",
    "EpicConfig",
    "EpicMIRDataset",
    "VOCAB_SIZE",
    "PrefetchLoader",
    "ShardedSampler",
    "collate",
    "datetime2sec",
    "generate_label_map",
    "get_frame_ids",
    "prepare_train_batch",
    "sample_frames",
    "sample_frames_clips",
    "sample_frames_start_end",
]
