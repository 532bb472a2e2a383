"""Drives of the port, each run with ``python -m``; importing does nothing.

``scaling_bench`` times the sharded update over meshes of 1..n cards;
``scaling_model_report`` evaluates the analytic scaling model
(:mod:`..parallel.scaling_model`) on the bench case.  The counterparts of
the JAX package's ``examples/``: ``profile_cycle`` (the fused cycle's stage
ablation), ``profile_groups`` (one group split into accumulation and
solve), ``gpu_drive`` (behavioural checks through ``update_points``),
``gpu_cli_drive`` (the streaming CLI with its metrics), ``run_synthetic_cycle``
(the CLI on the synthetic case) and ``memory_bench`` (host RSS of eager
against ``--stream``), over the case generators ``bench_case`` and
``wrf_case``.  Each drive runs on the card unless given ``--platform cpu``
(``device="cpu"`` for its functions) and raises without a card otherwise.
"""


def select_device(platform=None):
    """The device of a drive: the CPU for ``"cpu"``, else the card.

    ``platform`` is ``None``, ``"gpu"``, ``"cuda"``, ``"cpu"`` or a
    ``torch.device``.  Without a card, anything but the CPU raises: a drive
    never carries on on the CPU by itself.
    """
    import torch

    dev = torch.device("cuda" if platform in (None, "gpu") else platform)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a drive runs on 'cuda' or 'cpu', not {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the drive runs on the card; pass "
                           "--platform cpu (device='cpu') to run the plain "
                           "versions on the CPU")
    return dev


def device_label(dev):
    """``"cpu"``, or the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them for the first card: a card may be set below its maximum power and
    then runs slower."""
    import subprocess

    import torch

    if torch.device(dev).type != "cuda":
        return torch.device(dev).type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
