"""The analyzers' shared finding record (twin of `Finding` in
`agnes_tpu.analysis.jaxpr_audit`).

The twin keeps `Finding` in its jaxpr auditor, which has no subject in
the port (there is no jaxpr to audit, ROADMAP §1 "Needs no port"), so
the record lives here on its own, field for field: the pass that
raised it, its code (LOCK00x, LINT00x, RET001), where (`file:line` or
an entry name) and the message.  `lockcheck`, `lint`, `retrace` and
`lint_cli` report through it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Finding:
    pass_name: str
    code: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.pass_name}:{self.code}] {self.where}: " \
               f"{self.message}"
