from repro_torch.data.pipeline import PrefetchingLoader, synth_batch
