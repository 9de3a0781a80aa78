"""Facade mirroring reference ``orphics.io``."""
from .utils.io import (save_dict, load_dict, save_pickle, load_pickle,
                       get_hash, hash_dict, mkdir, save_cols, load_cols,
                       config_from_yaml, config_from_file, list_from_config,
                       bin_edges_from_config, cprint, bcolors, get_logger,
                       nostdout, load_path_config)
from .utils.plot import (Plotter, plot_img, hist, html_gallery, power_crop,
                         fplot, fisher_plot, FisherPlots, WhiskerPlot)
from .utils.io import (latex, DummyFile, no_context, proceedyn, dateversion,
                       print_dict, but_her_emails, LoggerWriter,
                       print_keys_tree, dict_from_section, prepare_dir,
                       join_nums, list_from_string, list_strings_from_config,
                       blend, datify)
from .utils.plot import (layered_contour, mplot, hplot, high_res_plot_img,
                         mollview, generate_gallery_html, write_gallery_html)
