"""``repro_torch.api`` — the declarative front door to the dataflow cost
model and every search engine behind it, on PyTorch (the port of
``repro.api``):

    from repro_torch.api import (Hardware, Query, SearchSpec, Session,
                                 Workload)

    s = Session(device="cpu")           # cuda by default

    # one layer, fixed hardware
    q = Query(Workload(model="vgg16", layer="conv13"),
              Hardware(num_pes=256, noc_bw=32.0),
              SearchSpec(objective="edp", budget=1000))
    report = s.run(q)
    print(report.best["value"], report.to_json())

    # grid hardware turns a layer query into a joint co-DSE
    s.run(Query(Workload(model="vgg16", layer="conv13"),
                Hardware(pe_range=(64, 128, 256), bw_range=(8.0, 32.0))))

    # a whole network; grid hardware turns it into a network co-DSE
    s.run(Query(Workload.of_network("vgg16")))

    # heterogeneous layer queries coalesced into one padded device pass
    # per (op-class, level-count) family
    reports = s.run_many([q1, q2, q3, q4, q5, q6])

See ``repro_torch.launch.query`` for the CLI (single queries and
``--file queries.json`` batch mode).
"""
from .report import Report
from .session import (PendingReport, Session, default_session, run,
                      run_many)
from .spec import (OP_BUILDERS, SCHEMA_VERSION, Hardware, Query,
                   SearchSpec, Workload, op_from_json, queries_from_file,
                   select_layers)

__all__ = [
    "Hardware", "OP_BUILDERS", "PendingReport", "Query", "Report",
    "SCHEMA_VERSION", "SearchSpec", "Session", "Workload",
    "default_session", "op_from_json", "queries_from_file", "run",
    "run_many", "select_layers",
]
