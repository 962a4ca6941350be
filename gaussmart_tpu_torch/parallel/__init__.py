from gaussmart_tpu_torch.parallel.sharding import (make_dp_train_step, make_mesh,
                                                   replicate)
