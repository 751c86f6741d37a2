"""Pretrained-asset download — the ``download_dataset.py`` / HF-weights
equivalent (ref:dataset/download_dataset.py, ref:mapf_gpt/inference.py:54-56);
a copy of ``mapf_gpt_tpu/dataset/download.py``.

Pulls the published MAPF-GPT artifacts from the Hugging Face Hub:

- dataset shards ``train/chunk_{i}_part_{j}.arrow`` + validation chunk from
  repo ``aandreychuk/MAPF-GPT`` (dataset),
- model weights ``MAPF-GPT-{2M,6M,85M}.pt`` (loaded with
  ``models/convert.load_reference_checkpoint``).

Network access and ``huggingface_hub`` are optional: in air-gapped
environments this module degrades to clear errors instead of import failures.
"""

from __future__ import annotations

import os

DATASET_REPO = "aandreychuk/MAPF-GPT"
WEIGHT_FILES = ("MAPF-GPT-2M.pt", "MAPF-GPT-6M.pt", "MAPF-GPT-85M.pt",
                "MAPF-GPT-DDG-2M.pt")


def _hub():
    try:
        import huggingface_hub
        return huggingface_hub
    except ImportError as exc:
        raise RuntimeError(
            "huggingface_hub is not installed; download is unavailable in "
            "this environment. Generate data locally with "
            "`python -m mapf_gpt_tpu_torch.dataset.generate` instead.") from exc


def download_weights(name: str = "MAPF-GPT-2M.pt",
                     local_dir: str = "weights") -> str:
    assert name in WEIGHT_FILES, name
    hub = _hub()
    os.makedirs(local_dir, exist_ok=True)
    return hub.hf_hub_download(repo_id=DATASET_REPO, filename=name,
                               local_dir=local_dir)


def download_dataset(local_dir: str = "dataset", chunks: int = 1,
                     parts_per_chunk: int = 50) -> list[str]:
    """Fetch training shards + the validation chunk
    (ref:dataset/download_dataset.py)."""
    hub = _hub()
    os.makedirs(local_dir, exist_ok=True)
    paths = []
    for i in range(chunks):
        for j in range(parts_per_chunk):
            paths.append(hub.hf_hub_download(
                repo_id=DATASET_REPO, repo_type="dataset",
                filename=f"train/chunk_{i}_part_{j}.arrow",
                local_dir=local_dir))
    paths.append(hub.hf_hub_download(
        repo_id=DATASET_REPO, repo_type="dataset",
        filename="validation/validation.arrow", local_dir=local_dir))
    return paths


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--what", choices=["weights", "dataset"],
                   default="weights")
    p.add_argument("--name", default="MAPF-GPT-2M.pt")
    p.add_argument("--local-dir", default=None)
    p.add_argument("--chunks", type=int, default=1)
    args = p.parse_args()
    if args.what == "weights":
        print(download_weights(args.name, args.local_dir or "weights"))
    else:
        for p_ in download_dataset(args.local_dir or "dataset", args.chunks):
            print(p_)


if __name__ == "__main__":
    main()
