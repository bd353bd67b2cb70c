"""``repro_torch.api`` — the declarative front door to the dataflow cost
model and the search engines behind it, on PyTorch (the port of
``repro.api``, layer half):

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

Network queries and ``run_many`` come with the port's netspace (ROADMAP
queue 1, item 3).  See ``repro_torch.launch.mapsearch`` for the CLI.
"""
from .report import Report
from .session import Session, default_session, run
from .spec import (OP_BUILDERS, SCHEMA_VERSION, Hardware, Query,
                   SearchSpec, Workload, op_from_json, queries_from_file,
                   select_layers)

__all__ = [
    "Hardware", "OP_BUILDERS", "Query", "Report", "SCHEMA_VERSION",
    "SearchSpec", "Session", "Workload", "default_session",
    "op_from_json", "queries_from_file", "run", "select_layers",
]
