from .tokenizer import CONTEXT_LENGTH, VOCAB_SIZE, ClipTokenizer

__all__ = ["ClipTokenizer", "CONTEXT_LENGTH", "VOCAB_SIZE"]
