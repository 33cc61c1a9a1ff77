from haconvdr_torch.mine.prj import (  # noqa: F401
    create_label_rel_turn,
    create_label_rel_token,
    create_topic_rel_turn,
    convert_gold_to_trec,
    create_prj_triples,
    improve_judge,
)
