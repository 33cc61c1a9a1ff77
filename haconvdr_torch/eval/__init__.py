from haconvdr_torch.eval.metrics import evaluate_run, trec_metrics  # noqa: F401
from haconvdr_torch.eval.trec import (  # noqa: F401
    read_qrels,
    read_run,
    write_run,
    print_trec_res,
    output_test_res,
)
