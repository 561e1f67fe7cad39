"""CLI: `python -m avenir_tpu_torch <jobName> --conf <props> IN... OUT [--device cpu] [--shard N]`.

The `hadoop jar avenir.jar <ToolClass> -Dconf.path=<props> IN OUT` surface
without the JVM; job names or full reference Tool class names are accepted.
`python -m avenir_tpu_torch serve|fleet|stats ...` runs the job server, a
fleet of them, or the metrics report (`runner.run_from_cli`).
"""

import sys

from avenir_tpu_torch.runner import run_from_cli


def main() -> None:
    run_from_cli(sys.argv[1:])


if __name__ == "__main__":
    main()
