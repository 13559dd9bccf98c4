"""peak_device_gib: torch.cuda.max_memory_allocated() over the window (the
peak is reset at its start), in GiB."""


def read(obs):
    return None if obs.peak_bytes is None else obs.peak_bytes / 2 ** 30
