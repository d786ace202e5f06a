#!/usr/bin/env python
"""Repo-root entry point of the PyTorch port: `python inspect_dataset_torch.py
--data=... --outdir=...` dumps random scenes of a dataset (a .npz scene
directory or a RealEstate10K root) to PNG strips; the counterpart of
inspect_dataset.py, on vivid_tpu_torch."""
from vivid_tpu_torch.cli.inspect_dataset import main

if __name__ == "__main__":
    main()
