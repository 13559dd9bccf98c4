"""LM training on the PyTorch port, with DP-SGD priced by the paper's
accountant: the port's counterpart of ``examples/train_lm.py``.

The architecture's reduced config by default; ``--no-reduced`` trains it at
its published widths.  Runs on CUDA unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-4b --steps 60 --dp-noise 1.0
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""
from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
