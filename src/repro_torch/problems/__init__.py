"""Problem families of the port; importing this package registers them."""

from repro_torch.problems.dominating_set import (  # noqa: F401
    make_dominating_set, make_dominating_set_py)
from repro_torch.problems.graphs import (  # noqa: F401
    Graph, cell60_graph, circulant_graph, full_mask, gnp_graph, num_words,
    parse_graph_instance, random_regularish_graph)
from repro_torch.problems.subset_sum import (  # noqa: F401
    SSInstance, make_subset_sum, make_subset_sum_py, parse_ss_instance)
from repro_torch.problems.vertex_cover import (  # noqa: F401
    make_vertex_cover, make_vertex_cover_py)
