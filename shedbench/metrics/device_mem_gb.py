"""device_mem_gb: the largest ``torch.cuda.max_memory_allocated`` of any
step of the window less what the harness holds on the card then (its
frame pool and the state copies of the correctness check), in 1e9 bytes:
the program's footprint on a card it shares with the backend's DNN."""


def read(rec):
    if rec.window.memory_peak is None:
        return None
    return rec.window.memory_peak / 1e9
