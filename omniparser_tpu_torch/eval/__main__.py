"""ScreenSpot-Pro eval CLI over the port's pipeline.

    python -m omniparser_tpu_torch.eval --dataset ss_pro.jsonl --out log.jsonl \
        --model gpt-4o --base_url https://api.openai.com/v1 [--device cpu]

dataset rows: {"img_path", "instruction", "gt_bbox" (ratio xyxy), "group"}.
--mock answers every row with a scripted "Click BBox ID: 0" (no API key,
no network).  The pipeline is PipelineConfig()'s on --device (default the
card; weights 'auto': the export).
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser("omniparser_tpu_torch screenspot eval")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", default="eval_log.jsonl")
    ap.add_argument("--model", default="gpt-4o")
    ap.add_argument("--base_url", default="https://api.openai.com/v1")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--mock", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.eval.screenspot import ScreenSpotModel, run_eval
    from omniparser_tpu_torch.pipeline import SOMPipeline

    with open(args.dataset) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if args.limit:
        rows = rows[: args.limit]

    if args.mock:
        from omniparser_tpu_torch.eval.llm import MockLLM

        llm = MockLLM(["Click BBox ID: 0"] * len(rows))
    else:
        from omniparser_tpu_torch.eval.llm import OpenAICompatClient

        llm = OpenAICompatClient(args.model, base_url=args.base_url)

    model = ScreenSpotModel(SOMPipeline(PipelineConfig(), args.device), llm)
    scores = run_eval(model, rows, log_path=args.out)
    print(json.dumps(scores, indent=2))


if __name__ == "__main__":
    main()
