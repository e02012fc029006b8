"""Command-line entry points of the port (``python -m
helping_hand_for_egocentric_videos_torch.cli.<tool>``)."""
