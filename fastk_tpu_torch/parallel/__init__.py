"""Multi-device counting over torch.distributed, one process a card."""
