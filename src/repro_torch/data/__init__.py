from repro_torch.data.pipeline import (SyntheticTokens, PackedFileDataset,
                                       Prefetcher)

__all__ = ["SyntheticTokens", "PackedFileDataset", "Prefetcher"]
