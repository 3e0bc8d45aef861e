"""The chat clients the eval harnesses call: ``OpenAICompatClient`` (an
OpenAI-compatible /chat/completions over raw HTTP, interleaved text and
images) and ``MockLLM`` (scripted answers), copied from the JAX package's
``agent/llm.py``; the agent itself is not ported.  ``requests`` is
imported at the first request.

Every client returns (text, token_usage_dict).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple


class OpenAICompatClient:
    """OpenAI-compatible /chat/completions with interleaved text+images.

    Handles the reference's provider quirks: o1/o3 use `reasoning_effort`
    + max_completion_tokens; o3-mini takes no images; dashscope/groq are
    the same wire format with other base URLs.
    """

    def __init__(self, model: str, api_key: Optional[str] = None,
                 base_url: str = "https://api.openai.com/v1", temperature: float = 0.7):
        self.model = model
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = base_url.rstrip("/")
        self.temperature = temperature

    def __call__(self, messages: List[Dict], system: str,
                 max_tokens: int = 2048) -> Tuple[str, Dict]:
        import requests

        content_msgs = [{"role": "system", "content": system}]
        for m in messages:
            content_msgs.append(self._convert(m))
        payload = {"model": self.model, "messages": content_msgs}
        if self.model.startswith(("o1", "o3")):
            payload["reasoning_effort"] = "medium"
            payload["max_completion_tokens"] = max_tokens
        else:
            payload["max_tokens"] = max_tokens
            payload["temperature"] = self.temperature
        resp = requests.post(
            f"{self.base_url}/chat/completions",
            headers={"Authorization": f"Bearer {self.api_key}"},
            json=payload, timeout=120,
        )
        if resp.status_code != 200:
            raise RuntimeError(f"LLM error [{resp.status_code}]: {resp.text[:300]}")
        data = resp.json()
        usage = data.get("usage", {})
        text = data["choices"][0]["message"]["content"]
        if "</think>" in text:  # R1-style reasoning strip
            text = text.split("</think>")[-1]
        return text, usage

    def _convert(self, m: Dict) -> Dict:
        no_images = self.model.startswith("o3-mini")
        if isinstance(m.get("content"), str):
            return {"role": m["role"], "content": m["content"]}
        parts = []
        for block in m["content"]:
            if block.get("type") == "text":
                parts.append({"type": "text", "text": block["text"]})
            elif block.get("type") == "image" and not no_images:
                b64 = block["source"]["data"]
                parts.append({"type": "image_url",
                              "image_url": {"url": f"data:image/png;base64,{b64}"}})
        return {"role": m["role"], "content": parts}


class MockLLM:
    """Deterministic scripted responses for CI; records prompts."""

    def __init__(self, responses: List[str]):
        self.responses = list(responses)
        self.calls: List[Dict] = []

    def __call__(self, messages, system, **kw) -> Tuple[str, Dict]:
        self.calls.append({"messages": messages, "system": system})
        text = self.responses.pop(0) if self.responses else json.dumps(
            {"Reasoning": "done", "Next Action": "None"}
        )
        return text, {"prompt_tokens": 10, "completion_tokens": 5}
