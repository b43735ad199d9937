"""Model upload to the Hugging Face Hub, with a generated model card.

Rebuild of the reference's Hub integration (reference:
``src/coral/utils.py:235-300``): rank-0-only upload of the final model directory
plus a model card carrying the training configuration. Degrades gracefully when
offline or when ``huggingface_hub`` is unavailable.

A copy of ``coral_tpu/utils/hub.py``; the model card names the port.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Any

logger = logging.getLogger(__package__)

MODEL_CARD_TEMPLATE = """---
language:
- da
library_name: coral-tpu
pipeline_tag: automatic-speech-recognition
---

# {model_id}

Danish ASR model fine-tuned with coral-tpu-torch (PyTorch, CUDA).

- Base checkpoint: `{pretrained_model_id}`
- Model family: `{model_type}`
- Datasets: {datasets}
- Total batch size: {total_batch_size}, max steps: {max_steps}

## Usage

```python
from coral_tpu_torch.evaluation.evaluate import load_saved_predictor
```
"""


def push_model_to_hub(config: Any, max_retries: int = 60) -> None:
    """Upload the final model directory (reference: ``utils.py:235-300``).

    Retries with a 1-minute backoff like the reference's upload loops.
    """
    if os.getenv("RANK", "0") != "0":
        return
    try:
        from huggingface_hub import HfApi
    except ImportError:
        logger.warning("huggingface_hub is not installed; skipping Hub push.")
        return

    model_dir = Path(config.model_dir)
    repo_id = f"{config.hub_organisation}/{config.model_id}"
    card = MODEL_CARD_TEMPLATE.format(
        model_id=config.model_id,
        pretrained_model_id=config.model.get("pretrained_model_id"),
        model_type=config.model.type,
        datasets=", ".join(config.datasets.keys()),
        total_batch_size=config.total_batch_size,
        max_steps=config.max_steps,
    )
    (model_dir / "README.md").write_text(card, encoding="utf-8")

    api = HfApi()
    for attempt in range(max_retries):
        try:
            api.create_repo(
                repo_id, private=bool(config.get("private", False)),
                exist_ok=True,
            )
            api.upload_folder(
                folder_path=str(model_dir),
                repo_id=repo_id,
                create_pr=bool(config.get("create_pr", False)),
            )
            logger.info(f"Pushed model to https://huggingface.co/{repo_id}")
            return
        except Exception as error:
            logger.warning(
                f"Hub upload failed (attempt {attempt + 1}/{max_retries}): "
                f"{error}"
            )
            time.sleep(60)
    logger.error("Giving up on the Hub upload.")
