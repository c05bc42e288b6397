"""python -m sv3d_tpu_torch.bench: the headline benchmark (headline.py)."""

from sv3d_tpu_torch.bench.headline import main

if __name__ == "__main__":
    main()
