"""Architecture configs (one module per LM architecture) and paper-plane
workload configurations.

:func:`load_all` imports every architecture module, which registers it in
the model registry (:mod:`repro_torch.models.config`).
"""
ARCH_IDS = (
    "xlstm-350m", "recurrentgemma-2b", "qwen2.5-14b", "qwen1.5-32b",
    "yi-34b", "qwen3-4b", "kimi-k2-1t-a32b", "deepseek-v2-236b",
    "chameleon-34b", "whisper-small",
)


def load_all():
    import importlib
    for a in ARCH_IDS:
        importlib.import_module(
            f"repro_torch.configs.{a.replace('-', '_').replace('.', '_')}")
